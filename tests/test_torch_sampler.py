"""The port's design sampler against JAX `Sampler.sample` (the slice).

Tiny config (num_recycle 1) at the runner's real-complex shape budget
(L = 256 + 32), num_t = 3, on testdata/6ct7_H_L_S.pdb.  The JAX `prepare`
output is handed to the port, both sides get the same dense random weights
and the same per-step noise (rot_z / trans_z normals, seq_u uniforms), and
every step must agree: backbone atoms (N, CA, C, O) within 0.1 A and
identical sequences (the PARITY.md §2.1 bar).  Plus the CLI smoke run.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import dataset as ds
from abx_tpu.data.dataset import DataConfig
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.sampling.sampler import Sampler as JaxSampler
from abx_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from abx_tpu_torch import config as port_config
from abx_tpu_torch.cli import runner
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import params as params_lib
from tests.torch_cpu_alloc import SUBPROCESS_ENV, lean_cpu

PDB = 'testdata/6ct7_H_L_S.pdb'
NUM_T = 3
BACKBONE_TOL = 0.1  # A


def _cfgs():
    cfg = jax_config.tiny_model_config()
    with cfg.unlocked():
        cfg.data.max_antibody_len = 256
        cfg.data.max_antigen_len = 32
    pcfg = port_config.tiny_model_config()
    pcfg.data.max_antibody_len = 256
    pcfg.data.max_antigen_len = 32
    return cfg, pcfg


def test_design_sampler_matches_jax_under_shared_noise():
    cfg, pcfg = _cfgs()
    l_ab = cfg.data.max_antibody_len
    ex = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    feats, _ = ds.prepare_example(ex, DataConfig(l_ab, 32), False)
    feats = ds.stack_batch([feats, feats])            # batch of 2 samples
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}

    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=l_ab)
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=NUM_T, mode='design', collect_trajectory=True))
    key = jax.random.PRNGKey(0)
    k_init, _ = jax.random.split(key)
    prepared = jsampler.prepare(k_init, jfeats)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), prepared,
                                            compute_loss=True))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        seed=1, scale=0.5)
    b, l = feats['seq'].shape
    rng = np.random.default_rng(2)
    noise = {'rot_z': rng.standard_normal((NUM_T + 1, b, l, 3)),
             'trans_z': rng.standard_normal((NUM_T + 1, b, l, 3)),
             'seq_u': rng.random((NUM_T + 1, b, l, 20))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    want = jsampler.sample(jax.tree.map(jnp.asarray, tree), jfeats, key,
                           noise={k: jnp.asarray(v) for k, v in noise.items()})

    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, l_ab).eval()
    params_lib.load_flax_params(pm, tree)
    psampler = Sampler(pm, pdiff, pcfg.model,
                       SamplerConfig(num_t=NUM_T, collect_trajectory=True))
    batch = to_device_batch(
        {k: np.asarray(v) for k, v in prepared.items()
         if not isinstance(v, tuple)}, 'cpu')
    with lean_cpu(threads=2):
        got = psampler.sample_prepared(
            batch, noise={k: torch.tensor(v) for k, v in noise.items()})

    jtraj = want['trajectory']
    assert len(got['trajectory']) == NUM_T == jtraj['t'].shape[0]
    devs = []
    for s, step in enumerate(got['trajectory']):
        np.testing.assert_array_equal(step['seq'].numpy(),
                                      np.asarray(jtraj['seq'][s]))
        bb = np.abs(step['atom14'].numpy()[..., :4, :]
                    - np.asarray(jtraj['atom14'][s])[..., :4, :])
        devs.append(float(bb.max()))
    print(f'max backbone deviation per step (A): {devs}')
    assert max(devs) <= BACKBONE_TOL, devs
    # Non-trivial: the designed region moved away from the input.
    assert not np.array_equal(got['seq'].numpy(), feats['seq'])


def test_cli_tiny_cpu_writes_pdbs(tmp_path):
    out = tmp_path / 'out'
    proc = subprocess.run(
        [sys.executable, '-m', 'abx_tpu_torch.cli.design', '--pdb_file', PDB,
         '--output_dir', str(out), '--tiny', '--device', 'cpu',
         '--num_t', '3'], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1', **SUBPROCESS_ENV))
    assert proc.returncode == 0, proc.stderr[-4000:]
    for sub in ('reference', '0000'):
        path = out / 'design' / sub / '6ct7_H_L_S.pdb'
        assert path.exists(), path
        chains = {line[21] for line in path.read_text().splitlines()
                  if line.startswith('ATOM')}
        assert chains == {'H', 'L', 'S'}, chains


def test_device_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        runner.resolve_device('cuda')
    assert runner.resolve_device('cpu').type == 'cpu'
