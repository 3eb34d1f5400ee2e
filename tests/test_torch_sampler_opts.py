"""The sampler's options, the sequence corrector and `sample_resumable` of
the port, against the JAX package.

Parity cases: the tiny config at the runner's real-complex shape budget
(L = 256 + 32) on testdata/6ct7_H_L_S.pdb, num_t 3, one sample; the JAX
`prepare` output is handed to the port, both sides get the same dense
random weights and the same per-step noise, and every step must agree:
backbone atoms within 0.1 A and identical sequences (PARITY.md §2.1).  The
corrector's own draws come from the port's generator and the JAX key, so
at sampler level it is held with corrector_scale = 0 (no jump may
happen), and as a function under shared uniforms.  `sample_resumable` is
held to `sample` bitwise on a small synthetic complex.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.data import dataset as ds
from abx_tpu.data.dataset import DataConfig
from abx_tpu.diffusion.discrete import DiscreteDiffuser as JaxDiscrete
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.sampling import sampler as jax_sampler_mod
from abx_tpu.sampling.sampler import Sampler as JaxSampler
from abx_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from abx_tpu_torch import config as port_config
from abx_tpu_torch.diffusion.discrete import DiscreteConfig, DiscreteDiffuser
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.sampling import sampler as sampler_mod
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import params as params_lib
from tests.test_torch_esm import _esm_cfgs, _esm_pair
from tests.test_torch_sampler import _cfgs

PDB = 'testdata/6ct7_H_L_S.pdb'
NUM_T = 3
BACKBONE_TOL = 0.1  # A
RATE_TOL = 1e-6     # corrector rates, relative to max|ref|


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The port's side on one thread: the parity runs are dominated by the
    JAX sampler, and torch's intra-op threads only add contention with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(grid, b, l, seed):
    rng = np.random.default_rng(seed)
    noise = {'rot_z': rng.standard_normal((grid, b, l, 3)),
             'trans_z': rng.standard_normal((grid, b, l, 3)),
             'seq_u': rng.random((grid, b, l, 20))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def _assert_same_trajectory(got, want):
    jtraj = want['trajectory']
    assert len(got['trajectory']) == jtraj['t'].shape[0]
    devs = []
    for s, step in enumerate(got['trajectory']):
        assert step['t'] == pytest.approx(float(jtraj['t'][s]))
        np.testing.assert_array_equal(step['seq'].numpy(),
                                      np.asarray(jtraj['seq'][s]))
        bb = np.abs(step['atom14'].numpy()[..., :4, :]
                    - np.asarray(jtraj['atom14'][s])[..., :4, :])
        devs.append(float(bb.max()))
    print(f'max backbone deviation per step (A): {devs}')
    assert max(devs) <= BACKBONE_TOL, devs


# --- the corrector -----------------------------------------------------------

def _corrector_case(seed, b=2, d=9, s=20):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, s, (b, d)).astype(np.int32)
    logits = (2.0 * rng.standard_normal((b, d, s))).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (b,)).astype(np.float32)
    return x, logits, t


@pytest.mark.parametrize('seed', [0, 1])
def test_corrector_rates_match_jax(seed):
    x, logits, t = _corrector_case(seed)
    want = np.asarray(JaxDiscrete().corrector_rates(
        jnp.asarray(x), jnp.asarray(logits), jnp.asarray(t)))
    got = DiscreteDiffuser().corrector_rates(
        torch.tensor(x.astype(np.int64)), torch.tensor(logits),
        torch.tensor(t)).numpy()
    assert np.abs(got - want).max() <= RATE_TOL * np.abs(want).max()
    assert (got >= 0).all() and (got[np.arange(2)[:, None],
                                     np.arange(9)[None], x] == 0).all()


def test_corrector_under_shared_uniforms_matches_jax():
    x, logits, t = _corrector_case(2, b=3, d=40)
    u = np.random.default_rng(3).random((3, 40, 20)).astype(np.float32)
    for dt in (0.01, 0.2):
        want = np.asarray(JaxDiscrete().corrector(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(logits),
            jnp.asarray(t), dt, u=jnp.asarray(u)))
        got = DiscreteDiffuser().corrector(
            None, torch.tensor(x.astype(np.int64)), torch.tensor(logits),
            torch.tensor(t), dt, u=torch.tensor(u)).numpy()
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)  # the dt=0.2 leap moved some sites


def test_corrector_generator_stationary_under_exact_posterior():
    """The corrector chain's generator R_t + R̂_t has the noising marginal
    q_t as a left null vector when the model posterior is exact (the port
    of the JAX package's identity test), on a single site with an
    arbitrary x0 prior."""
    s = 6
    diff = DiscreteDiffuser(DiscreteConfig(rate_const=0.5, num_states=s))
    pi0 = np.random.RandomState(0).dirichlet(np.ones(s))
    for t in (0.15, 0.6, 0.95):
        qt0 = diff.transition(torch.tensor([t])).double()[0].numpy()
        q_t = pi0 @ qt0
        g = np.zeros((s, s))
        for x in range(s):
            post = pi0 * qt0[:, x] / q_t[x]          # p(x0 | x_t = x)
            logits = torch.log(torch.tensor(post[None, None]).float()
                               + 1e-30)
            rates = diff.corrector_rates(torch.full((1, 1), x), logits,
                                         torch.tensor(float(t)))
            g[x] = rates[0, 0].double().numpy()
            g[x, x] = -g[x].sum()
        np.testing.assert_allclose(q_t @ g, 0.0, atol=1e-5)


def test_joint_reverse_center_and_noise_scale_match_jax():
    rng = np.random.default_rng(4)
    b, l = 2, 11
    quat = rng.standard_normal((b, l, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    rigids = np.concatenate([quat, 5 * rng.standard_normal((b, l, 3))],
                            -1).astype(np.float32)
    seq = rng.integers(0, 20, (b, l))
    rot_s, trans_s = (rng.standard_normal((b, l, 3)).astype(np.float32)
                      for _ in range(2))
    logits = rng.standard_normal((b, l, 20)).astype(np.float32)
    mask = (rng.random((b, l)) > 0.3).astype(np.float32)
    noise = {k: v[0] for k, v in _noise(1, b, l, 5).items()}
    t = np.full((b,), 0.6, np.float32)
    cfg, pcfg = _cfgs()
    jd = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    pd = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    for center, scale in ((True, 1.0), (False, 0.5)):
        jr, js = jd.reverse(
            jax.random.PRNGKey(0), jnp.asarray(rigids), jnp.asarray(seq),
            jnp.asarray(rot_s), jnp.asarray(trans_s), jnp.asarray(logits),
            jnp.asarray(t), 0.01, diffuse_mask=jnp.asarray(mask),
            center=center, noise_scale=scale,
            noise={k: jnp.asarray(v) for k, v in noise.items()})
        pr, ps = pd.reverse(
            None, torch.tensor(rigids), torch.tensor(seq),
            torch.tensor(rot_s), torch.tensor(trans_s),
            torch.tensor(logits), torch.tensor(t), 0.01,
            diffuse_mask=torch.tensor(mask), center=center,
            noise_scale=scale,
            noise={k: torch.tensor(v) for k, v in noise.items()})
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-5)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# --- the sampler's fields against JAX under shared noise ----------------------

@pytest.fixture(scope='module')
def trunk_pair():
    """(cfg, pcfg, JAX model, params tree, prepared batch, feats, port
    model), one sample of 6ct7 at L = 256 + 32."""
    cfg, pcfg = _cfgs()
    l_ab = cfg.data.max_antibody_len
    ex = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    feats, _ = ds.prepare_example(ex, DataConfig(l_ab, 32), False)
    jfeats = {k: jnp.asarray(v) for k, v in ds.stack_batch([feats]).items()}
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=l_ab)
    prepared = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=NUM_T)).prepare(jax.random.split(jax.random.PRNGKey(0))[0],
                              jfeats)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), prepared,
                                            compute_loss=True))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        seed=1, scale=0.5)
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, l_ab).eval()
    params_lib.load_flax_params(pm, tree)
    return cfg, pcfg, jm, jdiff, tree, prepared, jfeats, pm, pdiff


@pytest.mark.parametrize('opts', [
    dict(noise_scale=0.5, center=False, min_t=0.05),
    dict(self_conditioning=False),
    dict(seq_corrector_steps=2, corrector_scale=0.0),
], ids=['noise_scale_no_center_min_t', 'no_self_conditioning',
        'corrector_scale_0'])
def test_sampler_option_matches_jax_under_shared_noise(trunk_pair, opts):
    """One JAX compile a case: the options that keep the grid and add no
    step share a case; no self-conditioning shortens the grid and the
    corrector adds its jumps, so each has its own."""
    cfg, pcfg, jm, jdiff, tree, prepared, jfeats, pm, pdiff = trunk_pair
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=NUM_T, mode='design', collect_trajectory=True, **opts))
    psampler = Sampler(pm, pdiff, pcfg.model, SamplerConfig(
        num_t=NUM_T, collect_trajectory=True, **opts))
    grid = len(psampler.step_grids()[0])
    assert grid == NUM_T + (0 if opts.get('self_conditioning') is False
                            else 1)
    b, l = jfeats['seq'].shape
    noise = _noise(grid, b, l, 2)
    want = jsampler.sample(jax.tree.map(jnp.asarray, tree), jfeats,
                           jax.random.PRNGKey(0),
                           noise={k: jnp.asarray(v) for k, v in noise.items()})
    batch = to_device_batch({k: np.asarray(v) for k, v in prepared.items()
                             if not isinstance(v, tuple)}, 'cpu')
    got = psampler.sample_prepared(
        batch, torch.Generator().manual_seed(0),
        noise={k: torch.tensor(v) for k, v in noise.items()})
    _assert_same_trajectory(got, want)


@pytest.fixture(scope='module')
def esm_pair():
    num_t, l_ab = NUM_T, 256
    cfg, pcfg = _esm_cfgs(l_ab=l_ab, num_recycle=2)
    ex = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    feats, _ = ds.prepare_example(ex, DataConfig(l_ab, 32), False)
    jfeats = {k: jnp.asarray(v) for k, v in ds.stack_batch([feats]).items()}
    jesm, jesm_params, pesm = _esm_pair(l_ab, 12)
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=l_ab)
    prepared = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=num_t), esm_fn=jesm, esm_params=jesm_params).prepare(
            jax.random.split(jax.random.PRNGKey(0))[0], jfeats)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), prepared, compute_loss=True,
        esm_fn=lambda *a, **kw: jesm(jesm_params, *a, **kw)))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        seed=13, scale=0.5)
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, l_ab).eval()
    params_lib.load_flax_params(pm, tree)
    return (cfg, pcfg, jm, jdiff, jesm, jesm_params, tree, prepared, jfeats,
            pm, pdiff, pesm)


@pytest.mark.parametrize('refresh_every', [1, 2])
def test_esm_reuse_sampler_matches_jax_under_shared_noise(esm_pair,
                                                          refresh_every):
    """esm_reuse_recycles at num_recycle 2: one ESM pass at each refresh
    position of the 4-position grid (all four at k = 1, positions 0 and 2
    at k = 2), against the JAX sampler with the same options."""
    (cfg, pcfg, jm, jdiff, jesm, jesm_params, tree, prepared, jfeats, pm,
     pdiff, pesm) = esm_pair
    opts = dict(esm_reuse_recycles=True, esm_refresh_every=refresh_every)
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=NUM_T, mode='design', collect_trajectory=True, **opts),
        esm_fn=jesm, esm_params=jesm_params)
    b, l = jfeats['seq'].shape
    noise = _noise(NUM_T + 1, b, l, 14)
    want = jsampler.sample(jax.tree.map(jnp.asarray, tree), jfeats,
                           jax.random.PRNGKey(0),
                           noise={k: jnp.asarray(v) for k, v in noise.items()})
    calls = []
    hook = pesm.register_forward_hook(lambda *_: calls.append(1))
    try:
        psampler = Sampler(pm, pdiff, pcfg.model, SamplerConfig(
            num_t=NUM_T, collect_trajectory=True, **opts), esm_fn=pesm)
        batch = to_device_batch({k: np.asarray(v)
                                 for k, v in prepared.items()
                                 if not isinstance(v, tuple)}, 'cpu')
        got = psampler.sample_prepared(
            batch, noise={k: torch.tensor(v) for k, v in noise.items()})
    finally:
        hook.remove()
    assert len(calls) == {1: 4, 2: 2}[refresh_every]
    _assert_same_trajectory(got, want)


# --- port-only: reuse identity, sample_resumable -------------------------------

def _synthetic(l_ab=24, l_ag=6, batch=1, seed=0):
    rng = np.random.RandomState(seed)
    l = l_ab + l_ag
    anchor = np.zeros((batch, l_ab), np.int32)
    anchor[:, 6] = anchor[:, 14] = 5
    return {
        'seq': rng.randint(0, 20, (batch, l)).astype(np.int32),
        'mask': np.ones((batch, l), np.float32),
        'atom14_gt_positions': (5.0 * rng.randn(batch, l, 14, 3)).astype(
            np.float32),
        'atom14_gt_exists': np.ones((batch, l, 14), np.float32),
        'cdr_def': np.zeros((batch, l), np.int32),
        'chain_id': np.zeros((batch, l), np.int32),
        'residx': np.tile(np.arange(l, dtype=np.int32), (batch, 1)),
        'anchor_flag': anchor,
        'heavy_len': np.full((batch,), 14, np.int32),
        'light_len': np.full((batch,), 10, np.int32),
    }


def _port_model(esm=False, num_recycle=None, dtype=torch.float32, l_ab=24):
    """A tiny port model (and tiny ESM2) with dense random weights."""
    pcfg = port_config.tiny_model_config()
    if num_recycle is not None:
        pcfg.model.num_recycle = num_recycle
    pesm = None
    if esm:
        es = pcfg.model.embeddings_and_seqformer.esm
        es.enabled = True
        es.num_layers = port_esm.ESM2Config.tiny().num_layers
        es.embed_channel = port_esm.ESM2Config.tiny().embed_dim
        pesm = port_esm.AntibodyESM(port_esm.ESM2Config.tiny(), l_ab,
                                    sep_pad_num=4, dtype=dtype,
                                    device='cpu').eval()
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, l_ab, dtype=dtype).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in (pm, pesm):
            for p in (mod.parameters() if mod is not None else ()):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return pm, pdiff, pcfg, pesm


def _sampler(setup, **opts):
    pm, pdiff, pcfg, pesm = setup
    return Sampler(pm, pdiff, pcfg.model, SamplerConfig(**opts), esm_fn=pesm)


def _run(sampler, feats, seed=11, **kw):
    gen = torch.Generator().manual_seed(seed)
    batch = to_device_batch(feats, 'cpu')
    if kw:
        return sampler.sample_resumable(batch, gen, **kw)
    return sampler.sample(batch, gen)


class _Killed(Exception):
    """The process dying mid-trajectory."""


def _run_killed_after_first_chunk(sampler, feats, **kw):
    """`sample_resumable` killed as its second chunk starts, when the first
    chunk's state is already on disk."""
    run_steps = sampler._run_steps
    calls = []

    def die_on_second_call(*args, **kwargs):
        if calls:
            raise _Killed
        calls.append(1)
        return run_steps(*args, **kwargs)
    sampler._run_steps = die_on_second_call
    try:
        with pytest.raises(_Killed):
            _run(sampler, feats, **kw)
    finally:
        del sampler._run_steps


def _assert_bitwise(got, want, keys=('atom14', 'seq', 'rigids', 'plddt')):
    for k in keys:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope='module')
def small():
    return _port_model()


def test_esm_reuse_without_recycles_is_bitwise_the_default():
    """At num_recycle 0 every pass sees the step's input seq_t, so the
    seqformer's esm_weighted input gives the esm_fn path's bits."""
    setup = _port_model(esm=True, num_recycle=0)
    feats = _synthetic()
    off = _run(_sampler(setup, num_t=3), feats)
    on = _run(_sampler(setup, num_t=3, esm_reuse_recycles=True), feats)
    _assert_bitwise(on, off)


def test_resumable_chunked_equals_oneshot_bitwise(small, tmp_path):
    feats = _synthetic()
    sampler = _sampler(small, num_t=6)
    want = _run(sampler, feats)
    _assert_bitwise(_run(sampler, feats, chunk_steps=3), want)
    state = str(tmp_path / 'state.npz')
    _assert_bitwise(_run(sampler, feats, chunk_steps=2, state_path=state),
                    want)
    assert not os.path.exists(state)


def test_resumable_resumes_after_one_chunk(small, tmp_path):
    feats = _synthetic()
    sampler = _sampler(small, num_t=6)
    want = _run(sampler, feats)
    state = str(tmp_path / 'state.npz')
    _run_killed_after_first_chunk(sampler, feats, chunk_steps=3,
                                  state_path=state)
    saved = sampler_mod._load_npz(state)
    assert int(saved['__chunk_pos__']) == 3
    _assert_bitwise(_run(sampler, feats, chunk_steps=3, state_path=state),
                    want)
    assert not os.path.exists(state)


def test_resumable_bf16_state_round_trips(tmp_path):
    """bf16 carries survive the state file as 16-bit views with a dtype
    marker (the JAX package reads the same file), and a bf16 trunk resumes
    to `sample`'s bits."""
    import ml_dtypes
    path = str(tmp_path / 's.npz')
    x = torch.randn(3, 5).to(torch.bfloat16)
    sampler_mod._save_npz(path, {'prev_pair': x, 'rigids_t': torch.ones(2),
                                 '__chunk_pos__': np.asarray(3)})
    back = sampler_mod._load_npz(path)
    assert back['prev_pair'].dtype == torch.bfloat16
    assert torch.equal(back['prev_pair'], x)
    assert int(back['__chunk_pos__']) == 3
    jax_back = jax_sampler_mod._load_npz(path)
    assert jax_back['prev_pair'].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jax_back['prev_pair'].astype(np.float32),
                                  x.float().numpy())

    setup = _port_model(dtype=torch.bfloat16)
    feats = _synthetic()
    sampler = _sampler(setup, num_t=4)
    want = _run(sampler, feats)
    state = str(tmp_path / 'bf16_state.npz')
    _run_killed_after_first_chunk(sampler, feats, chunk_steps=2,
                                  state_path=state)
    saved = sampler_mod._load_npz(state)
    assert saved['prev_pair'].dtype == torch.bfloat16
    _assert_bitwise(_run(sampler, feats, chunk_steps=2, state_path=state),
                    want)


def test_resumable_keeps_the_esm_refresh_cache(tmp_path):
    """With esm_refresh_every 3 the cached embedding crosses the chunk
    boundary in the state file: a run killed after its first chunk and
    resumed gives `sample`'s bits, with one ESM pass at each of the grid's
    refresh positions 0 and 3 over both calls."""
    setup = _port_model(esm=True)
    feats = _synthetic()
    sampler = _sampler(setup, num_t=4, esm_reuse_recycles=True,
                       esm_refresh_every=3)
    want = _run(sampler, feats)
    state = str(tmp_path / 'esm_state.npz')
    calls = []
    hook = setup[3].register_forward_hook(lambda *_: calls.append(1))
    try:
        _run_killed_after_first_chunk(sampler, feats, chunk_steps=2,
                                      state_path=state)
        assert 'esm_cache' in sampler_mod._load_npz(state)
        got = _run(sampler, feats, chunk_steps=2, state_path=state)
    finally:
        hook.remove()
    assert len(calls) == 2
    _assert_bitwise(got, want)


def test_resumable_trajectory_resume_returns_the_whole_trajectory(
        small, tmp_path):
    feats = _synthetic()
    sampler = _sampler(small, num_t=6, mode='trajectory',
                       collect_trajectory=True)
    want = _run(sampler, feats)
    state = str(tmp_path / 'traj_state.npz')
    _run_killed_after_first_chunk(sampler, feats, chunk_steps=3,
                                  state_path=state)
    assert os.path.exists(state + '.traj')
    got = _run(sampler, feats, chunk_steps=3, state_path=state)
    assert len(got['trajectory']) == len(want['trajectory']) == 6
    for g, w in zip(got['trajectory'], want['trajectory']):
        assert g['t'] == w['t']
        _assert_bitwise(g, w, keys=('atom14', 'seq', 'plddt'))
    assert not os.path.exists(state + '.traj')


def test_sampler_argument_errors(small):
    pm, pdiff, pcfg, _ = small
    for bad in (dict(esm_refresh_every=0), dict(seq_corrector_steps=-1),
                dict(num_t=0), dict(mode='optimize'), dict(mode='nope')):
        with pytest.raises(ValueError):
            Sampler(pm, pdiff, pcfg.model, SamplerConfig(**bad))
    sampler = _sampler(small, num_t=2)
    with pytest.raises(ValueError, match='chunk_steps'):
        _run(sampler, _synthetic(), chunk_steps=0)
