"""The port's trainer-validation tool (`abx_tpu_torch/tools/overfit_6ct7.py`)
at a tiny size on the CPU: two training steps on testdata/6ct7_H_L_S.pdb
with a frozen tiny random ESM2 and the exact ELBO, then the EMA weights'
H3 samples in f32 and bf16 at the same seed, with every evaluation flag of
the JAX tool; then the revalidation tool
(`abx_tpu_torch/tools/revalidate_kernels.py`) on those weights."""

import csv
import json
import math
import os

import pytest

from abx_tpu_torch.tools import overfit_6ct7, revalidate_kernels
from tests.torch_cpu_alloc import lean_cpu


@pytest.fixture(autouse=True, scope='module')
def _lean_cpu():
    with lean_cpu():
        yield


def test_overfit_tool_writes_metrics_and_result(tmp_path, monkeypatch):
    # The composed recipe's num_t 25 is the JAX tool's (held by
    # tests/test_torch_quality_tools.py); at one step it runs the same code.
    monkeypatch.setattr(overfit_6ct7, 'FAST_RECIPE',
                        {**overfit_6ct7.FAST_RECIPE, 'num_t': 1})
    overfit_6ct7.main([
        '--tiny', '--steps', '2', '--batch', '1', '--num_t', '1',
        '--num_samples', '1', '--device', 'cpu', '--out', str(tmp_path),
        '--esm_random', '--esm_layers', '1', '--esm_dim', '64',
        '--exact_elbo', '--eval_esm_reuse', '--eval_esm_refresh', '2',
        '--eval_corrector', '1', '--eval_fast_recipe'])
    with open(tmp_path / 'metrics.csv', newline='', encoding='utf-8') as f:
        rows = list(csv.DictReader(f))
    assert [int(r['step']) for r in rows] == [2]
    assert math.isfinite(float(rows[0]['total']))
    with open(tmp_path / 'result.json', encoding='utf-8') as f:
        result = json.load(f)
    assert result['train']['steps'] == 2 and result['tiny']
    assert result['exact_elbo'] is True
    assert result['train']['loss_last']['total'] == float(rows[0]['total'])
    for dtype in ('f32', 'bf16'):
        ev = result['eval'][dtype]
        assert ev['n'] == 1 and len(ev['samples']) == 1
        assert math.isfinite(ev['h3_rmsd_mean'])
        assert 0.0 <= ev['h3_aar_mean'] <= 1.0
        for key in ('esm_reuse', 'esm_refresh_k2', 'corrector_t1_off',
                    'corrector_t1_k2', 'fast_recipe_t25'):
            block = result[key][dtype]
            assert block['n'] == 1 and len(block['samples']) == 1, key
            assert math.isfinite(block['h3_rmsd_mean']), key
            assert 0.0 <= block['h3_aar_mean'] <= 1.0, key
    delta = result['eval']['bf16_minus_f32'][0]
    assert delta['h3_rmsd'] == (result['eval']['bf16']['h3_rmsd_mean']
                                - result['eval']['f32']['h3_rmsd_mean'])
    assert (tmp_path / 'params.pt').exists()

    # The revalidation tool against that f32 baseline, on the CPU.
    rc = revalidate_kernels.main(['--run_dir', str(tmp_path), '--num_t', '1',
                                  '--num_samples', '1', '--device', 'cpu',
                                  '--tag', 'cpu'])
    with open(tmp_path / 'bf16_kernel_eval_cpu.json') as f:
        rec = json.load(f)
    assert rc == (0 if rec['quality'] == 'OK' else 1)
    assert rec['f32_h3_rmsd_per_sample'] == [
        round(result['eval']['f32']['h3_rmsd_mean'], 3)]
    assert rec['card'] == 'cpu' and rec['kernel_flags'] == {
        k: v for k, v in os.environ.items() if k.startswith('ABX_')}
    assert len(rec['abs_delta_per_sample']) == 1
    with pytest.raises(SystemExit):   # no f32 baseline at 2 samples
        revalidate_kernels.main(['--run_dir', str(tmp_path), '--num_t', '1',
                                 '--num_samples', '2', '--device', 'cpu'])
