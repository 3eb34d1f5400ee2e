"""The port's optimize and trajectory modes against the JAX package.

Forward marginals (the noising that optimize mode starts from) are held to
the JAX diffusers on what a fixed seed can check: the IGSO(3) angle CDF at
several t (Kolmogorov-Smirnov distance of 8000 draws), the R^3 mean and
variance against `marginal_b_t`, the CTMC stay frequency against
`transition(t)`, and the fixed region left untouched.

Optimize mode: shared-noise parity with JAX `Sampler(mode='optimize')`
from the JAX `prepare` output (tiny config at num_recycle 2, L = 14 + 5,
num_t 4, opt_step 2: two reverse steps and the prime step), with the
default flags and with the opt-in kernel flags on the forced kernel
routes: backbone atoms within 0.1 A and identical sequences at every step.

CLI: `cli/inference.py --tiny --device cpu` over an npz directory of both
test complexes, in optimize and in trajectory mode: the output tree, the
chains (X Z F E for 6qd7), the reference PDB text equal to the JAX
package's, and `--resume`.  `--device` defaults to cuda and raises
without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import dataset as jax_ds
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.sampling import output as jax_output
from abx_tpu.sampling.sampler import Sampler as JaxSampler
from abx_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from abx_tpu_torch import config as port_config
from abx_tpu_torch.cli import inference, runner
from abx_tpu_torch.data import dataset as port_ds
from abx_tpu_torch.diffusion.joint import (JointConfig, JointDiffuser,
                                           tensor7_join, tensor7_split)
from abx_tpu_torch.geometry import quat as port_quat
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import params as params_lib
from tests.test_torch_modules import (L_AB, OPT_IN, _feats,
                                      _force_kernel_route)

PDBS = ['testdata/6ct7_H_L_S.pdb', 'testdata/6qd7_X_Z_F|E.pdb']
NUM_T, OPT_STEP = 4, 2
BACKBONE_TOL = 0.1  # A
TS = [0.1, 0.5, 0.9]


@pytest.fixture(scope='module')
def diffusers():
    cfg = jax_config.tiny_model_config()
    pcfg = port_config.tiny_model_config()
    return (JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict())),
            JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict())))


# --- forward marginals ------------------------------------------------------

def test_igso3_forward_marginal_angle_cdf(diffusers):
    """The angle of rot_0^-1 rot_t follows the JAX IGSO(3) CDF table at t:
    KS distance of 8000 draws below 0.025 (the 99.9% bound is 0.022)."""
    jdiff, pdiff = diffusers
    n_draw = 8000
    rng = np.random.default_rng(40)
    rot_0 = torch.tensor(rng.standard_normal((len(TS), n_draw, 3)),
                         dtype=torch.float32)
    tv = torch.tensor(TS)
    rot_t, score = pdiff.so3.forward_marginal(
        torch.Generator().manual_seed(41), rot_0, tv)
    q = port_quat.quat_multiply(
        port_quat.invert_quat(port_quat.rotvec_to_quat(rot_0)),
        port_quat.rotvec_to_quat(rot_t))
    omega = torch.linalg.norm(port_quat.quat_to_rotvec(q), dim=-1).numpy()
    cdf = np.asarray(jdiff.so3._cdf[jdiff.so3.t_to_idx(jnp.asarray(TS))])
    grid = np.asarray(jdiff.so3.discrete_omega)
    for i in range(len(TS)):
        x = np.sort(omega[i])
        model = np.interp(x, grid, cdf[i])
        ecdf = np.arange(1, n_draw + 1) / n_draw
        ks = max(np.abs(ecdf - model).max(),
                 np.abs(ecdf - 1.0 / n_draw - model).max())
        assert ks < 0.025, (TS[i], ks)
    assert torch.isfinite(score).all()


def test_r3_forward_marginal_moments(diffusers):
    """In scaled units x_t = exp(-b/2) x_0 + sqrt(1 - exp(-b)) z with b the
    JAX marginal_b_t(t): mean within 5 sigma of the sample mean's spread,
    variance within 5%; the score is the JAX closed form."""
    jdiff, pdiff = diffusers
    rng = np.random.default_rng(42)
    x_0 = torch.tensor(20.0 * rng.standard_normal((len(TS), 6000, 3)),
                       dtype=torch.float32)
    tv = torch.tensor(TS)
    x_t, score = pdiff.r3.forward_marginal(torch.Generator().manual_seed(43),
                                           x_0, tv)
    beta = np.asarray(jdiff.r3.marginal_b_t(jnp.asarray(TS)))
    s = jdiff.r3.config.coordinate_scaling
    for i, b in enumerate(beta):
        resid = (s * x_t[i] - np.exp(-0.5 * b) * s * x_0[i]).numpy()
        var = 1.0 - np.exp(-b)
        assert abs(resid.mean()) < 5 * np.sqrt(var / resid.size), TS[i]
        assert abs(resid.var() / var - 1.0) < 0.05, (TS[i], resid.var(), var)
    want = jdiff.r3.score(jnp.asarray(s * x_t.numpy()),
                          jnp.asarray(s * x_0.numpy()), jnp.asarray(TS))
    np.testing.assert_allclose(score.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ctmc_forward_marginal_frequencies(diffusers):
    """x_t keeps its state with probability transition(t)[s, s] (JAX) and
    moves to each other state with the off-diagonal probability (5 sigma
    of the binomial spread); x_tilde differs from x_t at exactly one site
    per example."""
    jdiff, pdiff = diffusers
    rng = np.random.default_rng(44)
    n_site = 20000
    x_0 = torch.tensor(rng.integers(0, 20, (len(TS), n_site)))
    tv = torch.tensor(TS)
    x_tilde, qt0, rate, x_t = pdiff.seq.forward_marginal(
        torch.Generator().manual_seed(45), x_0, tv)
    jq = np.asarray(jdiff.seq.transition(jnp.asarray(TS)))
    np.testing.assert_allclose(qt0.numpy(), jq, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rate.numpy(),
                               np.asarray(jdiff.seq.rate(jnp.asarray(TS))),
                               rtol=1e-6)
    for i in range(len(TS)):
        p_stay, p_move = jq[i, 0, 0], jq[i, 0, 1]
        stay = (x_t[i] == x_0[i]).float().mean().item()
        assert abs(stay - p_stay) < 5 * np.sqrt(
            p_stay * (1 - p_stay) / n_site), (TS[i], stay, p_stay)
        offset = ((x_t[i] - x_0[i]) % 20).numpy()
        move = np.bincount(offset, minlength=20)[1:] / n_site
        assert np.abs(move - p_move).max() < 5 * np.sqrt(
            p_move * (1 - p_move) / n_site), (TS[i], move, p_move)
    assert ((x_tilde != x_t).sum(-1) == 1).all()


def test_joint_forward_marginal_keeps_the_fixed_region(diffusers):
    _, pdiff = diffusers
    rng = np.random.default_rng(46)
    b, l = 2, 30
    q = rng.standard_normal((b, l, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rigids_0 = torch.tensor(np.concatenate(
        [q, 10.0 * rng.standard_normal((b, l, 3))], -1), dtype=torch.float32)
    seq_0 = torch.tensor(rng.integers(0, 20, (b, l)))
    mask = torch.zeros(b, l, dtype=torch.long)
    mask[:, 10:17] = 1
    out = pdiff.forward_marginal(torch.Generator().manual_seed(47), rigids_0,
                                 seq_0, torch.tensor([0.3, 0.6]), mask)
    fixed = mask == 0
    trans_0, rot_0 = tensor7_split(rigids_0)
    same = tensor7_join(rot_0, trans_0)
    torch.testing.assert_close(out['rigids_t'][fixed], same[fixed],
                               rtol=0, atol=0)
    assert torch.equal(out['seq_t'][fixed], seq_0[fixed])
    for key in ('rot_score', 'trans_score'):
        assert (out[key][fixed] == 0).all(), key
    diffused = ~fixed
    assert not torch.allclose(out['rigids_t'][diffused], same[diffused])


# --- optimize mode: shared-noise parity with the JAX sampler ----------------

def _jax_optimize():
    cfg = jax_config.tiny_model_config()
    with cfg.unlocked():
        cfg.model.num_recycle = 2
    feats = {k: jnp.asarray(v) for k, v in _feats(48).items()}
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=L_AB)
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=NUM_T, mode='optimize', opt_step=OPT_STEP,
        collect_trajectory=True))
    key = jax.random.PRNGKey(49)
    k_init, _ = jax.random.split(key)
    prepared = jax.jit(jsampler.prepare)(k_init, feats)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), prepared,
                                            compute_loss=True))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        seed=50, scale=0.5)
    n_grid = len(np.asarray(jsampler.reverse_steps)) + 1
    b, l = feats['seq'].shape
    rng = np.random.default_rng(51)
    noise = {'rot_z': rng.standard_normal((n_grid, b, l, 3)),
             'trans_z': rng.standard_normal((n_grid, b, l, 3)),
             'seq_u': rng.random((n_grid, b, l, 20))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    want = jsampler.sample(jax.tree.map(jnp.asarray, tree), feats, key,
                           noise={k: jnp.asarray(v) for k, v in noise.items()})
    prepared = {k: np.asarray(v) for k, v in prepared.items()
                if not isinstance(v, tuple)}
    return jsampler, tree, prepared, noise, jax.tree.map(np.asarray, want)


@pytest.fixture(scope='module')
def jax_optimize():
    return _jax_optimize()


@pytest.mark.parametrize('route', ['default', 'opt_in'])
def test_optimize_sampler_matches_jax_under_shared_noise(jax_optimize, route,
                                                         monkeypatch):
    jsampler, tree, prepared, noise, want = jax_optimize
    if route == 'opt_in':
        _force_kernel_route(monkeypatch)
        for k, v in OPT_IN.items():
            monkeypatch.setenv(k, v)
    pcfg = port_config.tiny_model_config()
    pcfg.model.num_recycle = 2
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, L_AB).eval()
    params_lib.load_flax_params(pm, tree)
    psampler = Sampler(pm, pdiff, pcfg.model, SamplerConfig(
        num_t=NUM_T, mode='optimize', opt_step=OPT_STEP,
        collect_trajectory=True))
    np.testing.assert_array_equal(psampler.reverse_steps,
                                  np.asarray(jsampler.reverse_steps))
    np.testing.assert_array_equal(psampler.model_steps,
                                  np.asarray(jsampler.model_steps))
    assert len(psampler.reverse_steps) == 2      # t = 0.34, 0.01 <= 2/4
    np.testing.assert_allclose(prepared['t'], OPT_STEP / NUM_T)
    got = psampler.sample_prepared(
        to_device_batch(prepared, 'cpu'),
        noise={k: torch.tensor(v) for k, v in noise.items()})
    jtraj = want['trajectory']
    assert len(got['trajectory']) == len(psampler.reverse_steps)
    devs = []
    for s, step in enumerate(got['trajectory']):
        assert step['t'] == pytest.approx(float(jtraj['t'][s]))
        np.testing.assert_array_equal(step['seq'].numpy(), jtraj['seq'][s])
        bb = np.abs(step['atom14'].numpy()[..., :4, :]
                    - jtraj['atom14'][s][..., :4, :])
        devs.append(float(bb.max()))
    print(f'{route}: max backbone deviation per step (A): {devs}')
    assert max(devs) <= BACKBONE_TOL, devs


@pytest.mark.parametrize('num_t,opt_steps', [(100, (4, 8, 16, 32, 64)),
                                             (8, (1, 4, 7)), (5, (3,))])
def test_optimize_step_grids_match_jax(num_t, opt_steps):
    cfg = jax_config.tiny_model_config()
    pcfg = port_config.tiny_model_config()
    for k in opt_steps:
        js = JaxSampler(None, None, cfg.model, JaxSamplerConfig(
            num_t=num_t, mode='optimize', opt_step=k))
        ps = Sampler(None, None, pcfg.model, SamplerConfig(
            num_t=num_t, mode='optimize', opt_step=k))
        np.testing.assert_array_equal(ps.reverse_steps,
                                      np.asarray(js.reverse_steps))
        np.testing.assert_array_equal(ps.model_steps,
                                      np.asarray(js.model_steps))
        np.testing.assert_array_equal(ps.step_grids()[0][1:],
                                      ps.reverse_steps)
    with pytest.raises(ValueError, match='opt_step'):
        Sampler(None, None, pcfg.model, SamplerConfig(num_t=4,
                                                      mode='optimize'))


def test_optimize_prepare_renoises_to_opt_t(diffusers):
    """The port's own prepare: t = opt_step / num_t everywhere, the fixed
    region imputed from the input, the designed region re-noised."""
    _, pdiff = diffusers
    pcfg = port_config.tiny_model_config()
    sampler = Sampler(None, pdiff, pcfg.model, SamplerConfig(
        num_t=NUM_T, mode='optimize', opt_step=OPT_STEP))
    feats = {k: torch.tensor(v) for k, v in _feats(52).items()}
    batch = sampler.prepare(feats, torch.Generator().manual_seed(53))
    assert (batch['t'] == OPT_STEP / NUM_T).all()
    fixed = batch['fixed_mask'] > 0
    assert torch.equal(batch['seq_t'][fixed], batch['seq'].long()[fixed])
    trans_t, trans_0 = batch['rigids_t'][..., 4:], batch['rigids_0'][..., 4:]
    torch.testing.assert_close(trans_t[fixed], trans_0[fixed], rtol=0,
                               atol=0)
    assert (trans_t[~fixed] - trans_0[~fixed]).abs().max() > 0.1


# --- the test-set CLI --------------------------------------------------------

@pytest.fixture(scope='module')
def npz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('npz')
    names = []
    for pdb in PDBS:
        name = os.path.basename(pdb)[:-4]
        parts = name.split('_')
        ex = port_ds.complex_from_pdb(pdb, parts[1], parts[2],
                                      parts[3].split('|'))
        np.savez(d / f'{name}.npz', **ex)
        names.append(name)
    (d / 'names.txt').write_text('\n'.join(names) + '\n')
    return d, names


def _chains(path):
    return {line[21] for line in open(path) if line.startswith('ATOM')}


def _want_chains(name):
    return set(name.split('_', 1)[1].replace('|', '_').split('_'))


def _argv(npz_dir, out, *extra):
    d, _ = npz_dir
    return ['--data_dir', str(d), '--name_idx', str(d / 'names.txt'),
            '--output_dir', str(out), '--tiny', '--device', 'cpu',
            '--seed', '0', *extra]


def test_inference_cli_optimize_writes_opt_dirs_and_resumes(npz_dir,
                                                            tmp_path):
    _, names = npz_dir
    out = tmp_path / 'out'
    argv = _argv(npz_dir, out, '--mode', 'optimize', '--optimize_steps',
                 '1', '--num_t', '2', '--num_samples', '1')
    log = inference.main(argv)
    assert [name for name, _, _ in log] == names
    ref_texts = {}
    for name in names:
        path = out / 'optimize' / 'OPT-1' / '0000' / f'{name}.pdb'
        assert path.exists(), path
        assert _chains(path) == _want_chains(name), name
        ref = out / 'optimize' / 'reference' / f'{name}.pdb'
        ref_texts[name] = ref.read_text()
    # The reference PDBs are the JAX package's, byte for byte.
    d, _ = npz_dir
    dcfg = port_config.tiny_model_config().data
    for feats, meta in jax_ds.ComplexDataset(
            str(d), names, jax_ds.DataConfig(256, 32, dcfg.patch_radius,
                                             dcfg.anchor_neighbors)):
        path = jax_output.postprocess_reference(
            str(tmp_path), meta, jax_ds.stack_batch([feats]))
        assert open(path).read() == ref_texts[meta['name']], meta['name']
    # --resume: everything exists, nothing is sampled again.
    mtime = os.path.getmtime(out / 'optimize' / 'OPT-1' / '0000'
                             / f'{names[0]}.pdb')
    assert inference.main(argv + ['--resume']) == []
    assert os.path.getmtime(out / 'optimize' / 'OPT-1' / '0000'
                            / f'{names[0]}.pdb') == mtime


def test_inference_cli_trajectory_writes_every_step(npz_dir, tmp_path):
    """num_t 1: one reverse step (t = 0.01) after the prime step, which
    writes nothing; chip_smoke.py runs a 3-step trajectory at full width."""
    _, names = npz_dir
    out = tmp_path / 'out'
    inference.main(_argv(npz_dir, out, '--mode', 'trajectory', '--num_t',
                         '1', '--num_samples', '1'))
    for name in names:
        sdir = out / 'trajectory' / '0000'
        files = sorted(p.name for p in sdir.glob(f'{name}@*.pdb'))
        assert files == [f'{name}@0.0100.pdb'], files
        for f in files:
            assert _chains(sdir / f) == _want_chains(name), f


def test_resume_restarts_at_the_first_unfinished_chunk(tmp_path):
    name = '6qd7_X_Z_F|E'
    for i in (0, 1, 2):
        (tmp_path / f'{i:04d}').mkdir()
    (tmp_path / '0000' / f'{name}.pdb').write_text('')
    (tmp_path / '0001' / f'{name}@0.5000.pdb').write_text('')
    # Samples 0 and 1 are done; chunks of 2 restart at 2, chunks of 3 at 0.
    assert runner._first_unfinished(str(tmp_path), name, 4, 2) == 2
    assert runner._first_unfinished(str(tmp_path), name, 4, 3) == 0
    assert runner._first_unfinished(str(tmp_path), name, 2, 1) == 2


def test_inference_device_defaults_to_cuda_and_raises(npz_dir, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = [a for a in _argv(npz_dir, tmp_path) if a not in ('--device',
                                                             'cpu')]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.main(argv)
