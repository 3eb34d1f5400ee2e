"""The port's quality and rehearsal tools (`abx_tpu_torch/tools/
{revalidate_kernels,overfit_6ct7,multi_train_rehearsal,probe_picard}.py`)
against the JAX package's tools in `tools/`.

The JAX tools' arithmetic is run, not copied: each JAX tool's `main` runs
here with its runtime, featurizer and sampler replaced by fakes that hand
back the same canned samples the port's tool gets, and the records both
write are compared field for field.  The corpus of the rehearsal is built
by both tools from the same seed.  The rehearsal and the Picard probe then
run end to end on the CPU at the `--tiny` size (the overfit tool's flags
and the revalidation tool: tests/test_torch_overfit.py).
"""

import csv
import importlib.util
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from abx_tpu_torch.tools import (multi_train_rehearsal, overfit_6ct7,
                                 probe_picard, revalidate_kernels)
from tests.torch_cpu_alloc import lean_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, B = 24, 4


@pytest.fixture(autouse=True, scope='module')
def _lean_cpu():
    # The rehearsal's training runs are child processes.
    with lean_cpu(children=True):
        yield


def jax_tool(name):
    """A module of the JAX package's `tools/` directory (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tools_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def canned_feats():
    rng = np.random.default_rng(0)
    return {'atom14_gt_positions': rng.normal(size=(L, 14, 3)).astype(
                np.float32) * 5,
            'seq': rng.integers(0, 20, size=(L,)).astype(np.int32)}


def canned_sample(feats, num_t, esm_reuse, refresh, corrector, seed):
    """B samples whose distance from the truth depends on every sampler
    option and on the seed, so that each evaluation gets its own rows."""
    rng = np.random.default_rng(
        [num_t, int(esm_reuse), refresh, corrector, seed])
    mask = np.zeros((B, L), np.float32)
    mask[:, 4:14] = 1
    scale = 0.2 + 0.01 * num_t + 0.3 * esm_reuse + 0.05 * refresh \
        + 0.1 * corrector
    atom14 = (feats['atom14_gt_positions'][None]
              + scale * rng.normal(size=(B, L, 14, 3))).astype(np.float32)
    seq = np.repeat(feats['seq'][None], B, 0)
    flip = rng.random((B, L)) < 0.1 * scale
    seq = np.where(flip, (seq + 1) % 20, seq).astype(np.int32)
    return {'diffuse_mask': mask, 'atom14': atom14, 'seq': seq}


def rows_of(out, feats, n=B):
    """Per-sample H3 RMSD / AAR, as both tools compute them."""
    mask = out['diffuse_mask'][0] > 0
    gt_ca = feats['atom14_gt_positions'][:, 1]
    rows = []
    for i in range(n):
        rmsd = float(np.sqrt(np.mean(np.sum(
            (out['atom14'][i, :, 1][mask] - gt_ca[mask]) ** 2, -1))))
        aar = float(np.mean(out['seq'][i][mask] == feats['seq'][mask]))
        rows.append({'sample': i, 'h3_rmsd': rmsd, 'h3_aar': aar})
    return rows


def fake_jax_runtime(monkeypatch, feats):
    """The JAX tools' runtime, featurizer and sampler replaced by fakes
    that sample `canned_sample` (the PRNG key's seed read back)."""
    import jax
    from abx_tpu.cli import runner
    from abx_tpu.data import dataset
    from abx_tpu.sampling import sampler
    from abx_tpu.utils import checkpoint, compile_cache

    class FakeSampler:
        def __init__(self, model, diffuser, model_config, cfg, **kw):
            self.cfg = cfg

        def sample(self, params, sfeats, key):
            c = self.cfg
            return canned_sample(feats, c.num_t, c.esm_reuse_recycles,
                                 c.esm_refresh_every, c.seq_corrector_steps,
                                 int(jax.random.key_data(key)[-1]))

    rt = types.SimpleNamespace(data_config=None, model=None, diffuser=None,
                               config=types.SimpleNamespace(model=None),
                               esm_fn=None, esm_params=None, params=None)
    monkeypatch.setattr(runner, 'build_runtime', lambda *a, **k: rt)
    monkeypatch.setattr(dataset, 'complex_from_pdb', lambda *a, **k: None)
    monkeypatch.setattr(dataset, 'prepare_example',
                        lambda *a, **k: (feats, None))
    monkeypatch.setattr(sampler, 'Sampler', FakeSampler)
    monkeypatch.setattr(checkpoint, 'load_params', lambda *a, **k: {})
    monkeypatch.setattr(compile_cache, 'enable', lambda *a, **k: None)


def fake_port_runtime(monkeypatch, feats):
    """The same fakes for the port's tools."""
    from abx_tpu_torch.sampling import sampler

    class FakeSampler:
        def __init__(self, model, diffuser, model_config, cfg, esm_fn=None):
            self.cfg = cfg

        def sample(self, sfeats, generator):
            c = self.cfg
            out = canned_sample(feats, c.num_t, c.esm_reuse_recycles,
                                c.esm_refresh_every, c.seq_corrector_steps,
                                generator.initial_seed())
            return {k: torch.from_numpy(v) for k, v in out.items()}

    rt = types.SimpleNamespace(
        device=torch.device('cpu'), model=types.SimpleNamespace(
            dtype=torch.float32), diffuser=None,
        config=types.SimpleNamespace(model=None), esm=None)
    monkeypatch.setattr(sampler, 'Sampler', FakeSampler)
    monkeypatch.setattr(overfit_6ct7, 'complex_features', lambda rt: feats)
    monkeypatch.setattr(overfit_6ct7, 'eval_runtime', lambda *a, **k: rt)


def test_build_corpus_matches_jax_tool(tmp_path):
    jax_path, jax_holdout, jax_names = jax_tool(
        'multi_train_rehearsal').build_corpus(str(tmp_path / 'jax'), seed=0)
    path, holdout, names = multi_train_rehearsal.build_corpus(
        str(tmp_path / 'port'), seed=0)
    assert (holdout, names) == (jax_holdout, jax_names) == (
        '6ct7_v3', [f'{c}_v{i}' for c in ('6ct7', '6qd7') for i in range(8)])
    with open(path, encoding='utf-8') as f, open(jax_path,
                                                 encoding='utf-8') as g:
        assert f.read() == g.read()
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax'))
    for name in names:
        got = np.load(tmp_path / 'port' / f'{name}.npz')
        want = np.load(tmp_path / 'jax' / f'{name}.npz')
        assert sorted(got.files) == sorted(want.files), name
        for k in want.files:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=name)


# f32 RMSD offsets from the bf16 rows, and whether to spoil the AAR: within
# the bar; one sample 0.07 A off; the mean AAR under 0.99.
@pytest.mark.parametrize('offsets, spoil_aar, ok', [
    ([0.01, -0.02, 0.049, 0.0], False, True),
    ([0.01, 0.07, -0.03, 0.0], False, False),
    ([0.0, 0.0, 0.0, 0.0], True, False)])
def test_revalidation_matches_jax_tool(tmp_path, monkeypatch, capsys,
                                       offsets, spoil_aar, ok):
    feats = canned_feats()
    out = canned_sample(feats, 50, False, 1, 0, 1)
    if not spoil_aar:
        out['seq'] = np.repeat(feats['seq'][None], B, 0)
    rows = rows_of(out, feats)
    f32 = [r['h3_rmsd'] + d for r, d in zip(rows, offsets)]
    with open(tmp_path / 'bf16_kernel_eval.json', 'w') as f:
        json.dump({'f32_h3_rmsd_per_sample': f32}, f)

    fake_jax_runtime(monkeypatch, feats)
    from abx_tpu.sampling import sampler

    class Canned(sampler.Sampler):
        def sample(self, params, sfeats, key):
            return out
    monkeypatch.setattr(sampler, 'Sampler', Canned)
    monkeypatch.setattr(sys, 'argv', ['revalidate_kernels.py', '--run_dir',
                                      str(tmp_path), '--tag', 't'])
    rc = jax_tool('revalidate_kernels').main()
    with open(tmp_path / 'bf16_kernel_eval_t.json') as f:
        want = json.load(f)

    record, port_ok = revalidate_kernels.judge(f32, rows, 'port')
    assert (rc == 0) == port_ok == ok
    assert ('QUALITY OK' if ok else 'QUALITY REGRESSED') in \
        capsys.readouterr().out
    for k, v in want.items():
        if k != 'what':
            assert record[k] == v, k
    deltas = [abs(r['h3_rmsd'] - f) for r, f in zip(rows, f32)]
    assert record['abs_delta_per_sample'] == deltas
    assert record['n_over_0.05'] == sum(d > 0.05 for d in deltas)


def test_eval_flags_and_summarize_match_jax_tool(tmp_path, monkeypatch):
    """Both overfit tools' `--eval_only` with every evaluation flag: the
    same result keys, and for each the port's summary of the rows its own
    sampler options drew equals the JAX tool's."""
    feats = canned_feats()
    flags = ['--eval_only', '--eval_esm_reuse', '--eval_esm_refresh', '2',
             '4', '--eval_corrector', '10', '25', '--eval_fast_recipe']
    keys = ['esm_reuse', 'esm_refresh_k2', 'esm_refresh_k4',
            'corrector_t10_off', 'corrector_t10_k2', 'corrector_t25_off',
            'corrector_t25_k2', 'fast_recipe_t25']
    fake_jax_runtime(monkeypatch, feats)
    monkeypatch.setattr(sys, 'argv', ['overfit_6ct7.py', '--out',
                                      str(tmp_path / 'jax')] + flags)
    jax_tool('overfit_6ct7').main()
    with open(tmp_path / 'jax' / 'result.json') as f:
        want = json.load(f)

    fake_port_runtime(monkeypatch, feats)
    os.makedirs(tmp_path / 'port')
    with open(tmp_path / 'port' / 'result.json', 'w') as f:
        json.dump({'train': {}}, f)
    got = overfit_6ct7.main(['--out', str(tmp_path / 'port'),
                             '--device', 'cpu'] + flags)
    assert sorted(k for k in want if k in keys) == sorted(keys)
    assert sorted(k for k in got if k in keys) == sorted(keys)
    for key in keys:
        for dtype in ('f32', 'bf16'):
            block = dict(got[key][dtype])
            assert block.pop('seconds') >= 0
            assert block == want[key], (key, dtype)
    base = dict(got['eval']['f32'])
    base.pop('seconds')
    assert base['samples'] == want['samples']
    for k in ('h3_rmsd_best', 'h3_rmsd_mean', 'h3_aar_best', 'h3_aar_mean'):
        assert base[k] == want[k], k


def test_rehearsal_kills_and_resumes_tiny_cpu(tmp_path):
    res = multi_train_rehearsal.main([
        '--tiny', '--device', 'cpu', '--steps', '4', '--checkpoint_every',
        '2', '--batch', '1', '--num_t', '1', '--num_samples', '1',
        '--out', str(tmp_path / 'out'), '--work', str(tmp_path / 'work')])
    events = [e['event'] for e in res['timeline']]
    assert events == ['corpus_build_start', 'corpus_built', 'train_start',
                      'sigkill', 'resume_start', 'resume_done',
                      'holdout_eval_done']
    assert res['timeline'][3]['checkpoint_step'] == 2
    with open(tmp_path / 'work' / 'train' / 'resume.log') as f:
        assert 'resumed full training state at step 2' in f.read()
    with open(tmp_path / 'out' / 'metrics.csv', newline='') as f:
        assert [int(float(r['step'])) for r in csv.DictReader(f)] == [2, 4]
    assert res['last_step'] == 4 and res['metric_rows'] == 2
    ev = res['holdout_eval']
    assert ev['generate_area'] == 'cdr' and len(ev['samples']) == 1
    assert math.isfinite(ev['cdr_rmsd_mean'])
    with open(tmp_path / 'out' / 'result.json') as f:
        assert json.load(f)['corpus']['holdout'] == '6ct7_v3'


def test_picard_probe_tiny_cpu_matches_sequential(tmp_path):
    res = probe_picard.main(['--tiny', '--device', 'cpu', '--num_t', '1',
                             '--out', str(tmp_path)])
    e = res['configs']['t1']
    for tol in ('tol0', 'tol1e-4'):
        assert e[tol]['grid_len'] == 2
        assert 1 <= e[tol]['sweeps'] <= e[tol]['grid_len'], tol
        assert e[tol]['deltas_first8'][-1] <= (1e-4 if tol != 'tol0' else 0)
    assert e['tol0']['seq_matches_sequential']
    assert e['tol0']['atom14_max_dev_A'] <= 1e-3
    with open(tmp_path / 'result.json') as f:
        assert json.load(f)['configs']['t1']['tol0']['sweeps'] == \
            e['tol0']['sweeps']
