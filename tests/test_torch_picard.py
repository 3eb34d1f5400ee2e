"""The port's parallel-in-time (Picard) sampler, on the CPU.

* Against the port's sequential sampler under the same injected noise
  (tiny model, f32, 19 residues, num_t 3 and 4, without and with one
  Gibbs-corrector jump a step whose uniforms are injected too): the last
  sweep's change is 0 (a bitwise fixpoint), within grid + 1 sweeps,
  sequences identical at every step, coordinates to 1e-5 A.
* Against JAX `picard_sample` on the same bridged dense random weights, the
  JAX `Sampler.prepare` output and the same numpy noise: sequences
  identical at every step, coordinates to 1e-4 (rtol and atol, as
  tests/test_picard.py holds the JAX Picard to its sequential scan), the
  same sweep count.
* With its time axis over 2 gloo ranks (the grid of 5 padded to 6) it
  equals one process: sweeps, deltas and sequences identical, coordinates
  to 1e-5 A.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (L_AB, L_AG, _run_ranks,
                                       _train_feats as _feats)

COORD_TOL = 1e-5
JAX_COORD_TOL = 1e-4


def _port_model(tree=None):
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
    from abx_tpu_torch.models.modules import reset_parameters
    from abx_tpu_torch.models.network import ScoreNetworkIteration
    from abx_tpu_torch.utils import params as params_lib
    cfg = config_lib.tiny_model_config()
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()))
    model = ScoreNetworkIteration(cfg.model, diffuser, L_AB)
    if tree is None:
        reset_parameters(model, 0)
    else:
        params_lib.load_flax_params(model, tree)
    return cfg, diffuser, model.eval()


def _sampler(num_t, corrector=0):
    from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
    cfg, diffuser, model = _port_model()
    return Sampler(model, diffuser, cfg.model, SamplerConfig(
        num_t=num_t, collect_trajectory=True,
        seq_corrector_steps=corrector))


def _noise(sampler, b, seed=3):
    from abx_tpu_torch.sampling.picard import draw_noise
    n = len(sampler.step_grids()[0])
    return draw_noise(torch.Generator().manual_seed(seed), n, b,
                      L_AB + L_AG, corrector_steps=sampler.config
                      .seq_corrector_steps)


def _assert_same_trajectory(got, want, tol):
    assert len(got['trajectory']) == len(want['trajectory'])
    for g, w in zip(got['trajectory'], want['trajectory']):
        assert g['t'] == w['t']
        assert torch.equal(g['seq'], w['seq'])
        assert (g['atom14'] - w['atom14']).abs().max().item() <= tol
    assert (got['rigids'] - want['rigids']).abs().max().item() <= tol


@pytest.mark.parametrize('num_t,corrector', [(3, 0), (4, 1)])
def test_picard_reaches_the_sequential_sampler(num_t, corrector):
    from abx_tpu_torch.sampling.picard import picard_sample
    from abx_tpu_torch.sampling.sampler import to_device_batch
    torch.set_num_threads(1)
    sampler = _sampler(num_t, corrector)
    feats = to_device_batch(_feats(b=2), 'cpu')
    noise = _noise(sampler, 2)
    want = sampler.sample(feats, torch.Generator().manual_seed(1), noise)
    got = picard_sample(sampler, feats, torch.Generator().manual_seed(1),
                        noise=noise, tol=0.0)
    grid = len(sampler.step_grids()[0])
    assert got['picard']['deltas'][-1] == 0.0
    assert got['picard']['sweeps'] <= grid + 1
    _assert_same_trajectory(got, want, COORD_TOL)
    # Non-trivial: the designed sequence moved from its initial draw.
    assert got['picard']['deltas'][0] > 0.0


def test_picard_matches_jax_picard_sample():
    import jax
    import jax.numpy as jnp
    from abx_tpu import config as jax_config
    from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
    from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
    from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
    from abx_tpu.sampling import picard as jax_picard
    from abx_tpu.sampling.sampler import Sampler as JaxSampler
    from abx_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
    from abx_tpu_torch.sampling.picard import picard_sample_prepared
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    from abx_tpu_torch.utils import params as params_lib
    torch.set_num_threads(1)
    num_t, b = 2, 2
    cfg = jax_config.tiny_model_config()
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=L_AB)
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=num_t, mode='design', collect_trajectory=True))
    jfeats = {k: jnp.asarray(v) for k, v in _feats(b=b).items()}
    key = jax.random.PRNGKey(0)
    prepared = jsampler.prepare(jax.random.split(key)[0], jfeats)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), prepared,
                                            compute_loss=True))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        seed=1, scale=0.5)
    n = num_t + 1
    l = L_AB + L_AG
    rng = np.random.default_rng(2)
    noise = {'rot_z': rng.standard_normal((n, b, l, 3)),
             'trans_z': rng.standard_normal((n, b, l, 3)),
             'seq_u': rng.random((n, b, l, 20))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    want = jax_picard.picard_sample(
        jsampler, jax.tree.map(jnp.asarray, tree), jfeats, key,
        noise={k: jnp.asarray(v) for k, v in noise.items()}, tol=0.0)

    pcfg, pdiff, pm = _port_model(tree)
    psampler = Sampler(pm, pdiff, pcfg.model, SamplerConfig(
        num_t=num_t, collect_trajectory=True))
    batch = to_device_batch({k: np.asarray(v) for k, v in prepared.items()
                             if not isinstance(v, tuple)}, 'cpu')
    got = picard_sample_prepared(
        psampler, batch, noise={k: torch.tensor(v) for k, v in noise.items()})
    assert got['picard']['sweeps'] == want['picard']['sweeps']
    assert got['picard']['deltas'][-1] == 0.0
    jtraj = want['trajectory']
    assert len(got['trajectory']) == num_t == jtraj['t'].shape[0]
    for s, step in enumerate(got['trajectory']):
        np.testing.assert_array_equal(step['seq'].numpy(),
                                      np.asarray(jtraj['seq'][s]))
        np.testing.assert_allclose(step['atom14'].numpy(),
                                   np.asarray(jtraj['atom14'][s]),
                                   rtol=JAX_COORD_TOL, atol=JAX_COORD_TOL)
    np.testing.assert_allclose(got['rigids'].numpy(),
                               np.asarray(want['rigids']),
                               rtol=JAX_COORD_TOL, atol=JAX_COORD_TOL)


def _picard_run(mesh):
    from abx_tpu_torch.sampling.picard import picard_sample
    from abx_tpu_torch.sampling.sampler import to_device_batch
    sampler = _sampler(4)
    feats = to_device_batch(_feats(b=2), 'cpu')
    out = picard_sample(sampler, feats, torch.Generator().manual_seed(1),
                        noise=_noise(sampler, 2), mesh=mesh)
    return {'picard': out['picard'], 'seq': out['seq'],
            'atom14': out['atom14'], 'rigids': out['rigids'],
            'traj_seq': [s['seq'] for s in out['trajectory']]}


def _worker(case, rank, world, port, tmp, kw):
    import torch.distributed as dist
    from abx_tpu_torch.parallel import mesh as mesh_lib
    from tests.test_torch_parallel import _join
    _join(rank, world, port)
    try:
        out = _picard_run(mesh_lib.make_mesh())
        torch.save(out, os.path.join(tmp, f'{case}_{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_picard_time_axis_over_two_ranks_equals_one_process(tmp_path):
    _run_ranks('tests.test_torch_picard', 'picard', 2, tmp_path)
    torch.set_num_threads(1)
    want = _picard_run(None)
    assert want['picard']['deltas'][-1] == 0.0
    for r in range(2):
        got = torch.load(tmp_path / f'picard_{r}.pt')
        assert got['picard'] == want['picard']
        assert torch.equal(got['seq'], want['seq'])
        for g, w in zip(got['traj_seq'], want['traj_seq']):
            assert torch.equal(g, w)
        for k in ('atom14', 'rigids'):
            assert (got[k] - want[k]).abs().max().item() <= COORD_TOL, k
