"""The port stands alone: it imports nothing of the JAX package, and its
own copies of the JAX package's framework-free data and output modules
give the same results.

The import check runs in a subprocess in which `abx_tpu`, `jax`, `flax`,
`optax`, `ml_collections`, `msgpack` and `orbax` cannot be imported: every
module under `abx_tpu_torch/` (the evaluation and training subpackages and
their CLIs included) and `chip_smoke.py` are imported there, the design
CLI makes one tiny CPU sample, the test-set CLI (`cli/inference.py`) one
tiny CPU optimize sample from an npz the port writes itself, and the
training CLI one tiny CPU step on that npz.  The data
check holds the port's `prepare_example` to the JAX package's on the
repository's test complexes (integers exact, floats to 1e-6) and compares
the PDB text both packages write.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from abx_tpu.data import dataset as jax_ds
from abx_tpu.sampling import output as jax_output
from abx_tpu_torch import config as port_config
from abx_tpu_torch.data import dataset as port_ds
from abx_tpu_torch.sampling import output as port_output
from tests.torch_cpu_alloc import SUBPROCESS_ENV

BLOCKED = ('abx_tpu', 'jax', 'flax', 'optax', 'ml_collections', 'msgpack',
           'orbax')
PDBS = ['testdata/6ct7_H_L_S.pdb', 'testdata/6qd7_X_Z_F|E.pdb']


def test_port_runs_with_the_jax_package_blocked(tmp_path):
    out = tmp_path / 'out'
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of it raises ImportError
import abx_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(abx_tpu_torch.__path__,
                                               'abx_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
assert {{'abx_tpu_torch.evaluation.relax', 'abx_tpu_torch.evaluation.pll',
         'abx_tpu_torch.cli.eval_pll', 'abx_tpu_torch.train.losses',
         'abx_tpu_torch.train.trainer', 'abx_tpu_torch.utils.checkpoint',
         'abx_tpu_torch.data.pipeline', 'abx_tpu_torch.cli.train',
         'abx_tpu_torch.parallel.mesh', 'abx_tpu_torch.parallel.esm_tp',
         'abx_tpu_torch.sampling.picard', 'abx_tpu_torch.utils.prof',
         'abx_tpu_torch.tools.revalidate_kernels',
         'abx_tpu_torch.tools.multi_train_rehearsal',
         'abx_tpu_torch.tools.probe_picard'}} <= set(mods), mods
import chip_smoke
import numpy as np
from abx_tpu_torch.cli import design, inference, train
from abx_tpu_torch.data import dataset
design.main(['--pdb_file', {PDBS[0]!r}, '--output_dir', {str(out)!r},
             '--tiny', '--device', 'cpu', '--num_t', '2'])
np.savez({str(tmp_path / '6ct7_H_L_S.npz')!r},
         **dataset.complex_from_pdb({PDBS[0]!r}, 'H', 'L', ['S']))
with open({str(tmp_path / 'names.txt')!r}, 'w') as f:
    f.write('6ct7_H_L_S\\n')
inference.main(['--data_dir', {str(tmp_path)!r}, '--name_idx',
                {str(tmp_path / 'names.txt')!r}, '--output_dir',
                {str(out)!r}, '--tiny', '--device', 'cpu', '--mode',
                'optimize', '--optimize_steps', '1', '--num_t', '2',
                '--num_samples', '1'])
train.main(['--data_dir', {str(tmp_path)!r}, '--name_idx',
            {str(tmp_path / 'names.txt')!r}, '--output_dir',
            {str(out / 'train')!r}, '--tiny', '--device', 'cpu',
            '--batch_size', '1', '--num_steps', '1', '--prefetch', '0'])
print(len(mods))
"""
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS='1',
                                   **SUBPROCESS_ENV))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 40
    for sub in ('reference', '0000'):
        assert (out / 'design' / sub / '6ct7_H_L_S.pdb').exists(), sub
    for sub in ('reference', 'OPT-1/0000'):
        assert (out / 'optimize' / sub / '6ct7_H_L_S.pdb').exists(), sub
    assert (out / 'train' / 'params.pt.train').exists()


def _prepare(ds, path):
    c = port_config.load_config('config/config_model.json').data
    cfg = ds.DataConfig(c.max_antibody_len, c.max_antigen_len,
                        c.patch_radius, c.anchor_neighbors)
    parts = path.rsplit('/', 1)[-1][:-4].split('_')
    ex = ds.complex_from_pdb(path, parts[1], parts[2], parts[3].split('|'))
    return ds.prepare_example(ex, cfg, False)


def _assert_same(got, want, key):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_same(got[k], want[k], f'{key}.{k}')
    elif isinstance(want, np.ndarray) and want.dtype.kind == 'f':
        assert got.dtype == want.dtype, key
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=key)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        assert got == want, key


@pytest.mark.parametrize('path', PDBS)
def test_prepared_example_and_pdb_text_match_jax(path, tmp_path):
    (pfeats, pmeta), (jfeats, jmeta) = (_prepare(port_ds, path),
                                        _prepare(jax_ds, path))
    _assert_same(pfeats, jfeats, 'feats')
    _assert_same(pmeta, jmeta, 'meta')
    batch = port_ds.stack_batch([pfeats])
    rng = np.random.default_rng(0)
    result = {'seq': rng.integers(0, 20, batch['seq'].shape),
              'atom14': batch['atom14_gt_positions']
              + rng.standard_normal(batch['atom14_gt_positions'].shape),
              'plddt': np.array([73.25])}
    texts = []
    for i, out in enumerate((port_output, jax_output)):
        d = tmp_path / str(i)
        (d / 's').mkdir(parents=True)
        files = [out.postprocess_reference(str(d), pmeta, batch),
                 out.postprocess_sample(str(d / 's'), pmeta, result)]
        texts.append([open(f).read() for f in files])
    assert texts[0] == texts[1]
    chains = {line[21] for line in texts[0][0].splitlines()
              if line.startswith('ATOM')}
    want_chains = set(path[:-4].split('_', 1)[1].replace('|', '_')
                      .split('_'))
    assert chains == want_chains
