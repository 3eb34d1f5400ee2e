"""The port's training losses against the JAX package's.

The same numpy (batch, outputs) go through each loss function of
`abx_tpu/train/losses.py` and of `abx_tpu_torch/train/losses.py`: the
batch is the JAX feature pipeline's (tiny config, t pinned per case on
both sides of the loss gates), the outputs are seeded random predictions
(scores, rigids, the per-layer frames, atoms and the heads' logits).
Every returned value agrees to 1e-5 relative, and the gradient with
respect to every prediction to 1e-4 relative (in norm).  Both
`exact_elbo` paths are covered, and the reverted-corruption case (the
diffuse mask undid the forward jump: jump term 0, everything finite).
Each JAX value-and-grad is compiled once for the file.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import features as jax_features
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.geometry import quat as jax_quat
from abx_tpu.geometry.rigid import Rigid as JaxRigid
from abx_tpu.train import losses as jax_losses
from abx_tpu_torch import config as port_config
from abx_tpu_torch.geometry.rigid import Rigid
from abx_tpu_torch.train import losses as port_losses
from tests.test_torch_modules import L_AB, _feats

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
NUM_TRAJ = 2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _port_batch(jbatch):
    """The JAX batch as tensors (its Rigids as the port's Rigid)."""
    out = {}
    for k, v in jbatch.items():
        if isinstance(v, tuple):
            out[k] = Rigid(*(torch.tensor(np.asarray(x)) for x in v))
            continue
        a = np.asarray(v)
        out[k] = torch.tensor(a.astype(np.float32) if a.dtype.kind == 'f'
                              else a.astype(np.int64))
    return out


@pytest.fixture(scope='module')
def base():
    cfg = jax_config.tiny_model_config()
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    feats = {k: jnp.asarray(v) for k, v in _feats(5).items()}
    batch = jax_features.FeatureBuilder(is_training=True)(feats)
    batch = jax_features.make_diffuser_features(
        batch, diffuser=jdiff, generate_area='H3', key=jax.random.PRNGKey(2),
        mode='optimize', t_value=0.1, is_training=True)
    b, l = batch['seq'].shape
    rng = np.random.default_rng(6)

    def quats(shape):
        q = rng.standard_normal(shape + (4,)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.asarray(batch['atom14_gt_positions'])
    traj = []
    for _ in range(NUM_TRAJ):
        rot = np.asarray(jax_quat.quat_to_rot(jnp.asarray(quats((b, l)))))
        traj.append((rot, (10 * rng.standard_normal((b, l, 3))
                           ).astype(np.float32)))
    preds = {
        'trans_score': rng.standard_normal((b, l, 3)).astype(np.float32),
        'rot_score': rng.standard_normal((b, l, 3)).astype(np.float32),
        'rigids': np.concatenate(
            [quats((b, l)), (10 * rng.standard_normal((b, l, 3)))
             .astype(np.float32)], -1),
        'final_atom14_positions': (pos + 0.7 * rng.standard_normal(pos.shape)
                                   ).astype(np.float32),
        'seq_logits': rng.standard_normal((b, l, 20)).astype(np.float32),
        'disto_logits': rng.standard_normal((b, l, l, 64)).astype(np.float32),
        'plddt_logits': rng.standard_normal((b, l, 50)).astype(np.float32),
        'traj': traj,
    }
    return cfg, batch, preds


def _outputs(preds, rigid_cls, disto_breaks):
    """The heads dict of a forward from the prediction leaves."""
    folding = {k: preds[k] for k in ('trans_score', 'rot_score', 'rigids',
                                     'final_atom14_positions')}
    folding['traj'] = [rigid_cls(rot, trans) for rot, trans in preds['traj']]
    return {'heads': {
        'folding': folding,
        'sequence_module': {'logits': preds['seq_logits']},
        'distogram': {'logits': preds['disto_logits'],
                      'breaks': disto_breaks},
        'predicted_lddt': {'logits': preds['plddt_logits']},
    }}


def _jax_call(name, cfg, batch, preds):
    heads = _outputs(preds, JaxRigid, jnp.linspace(
        2.3125, 21.6875, 63))['heads']
    lc = cfg.loss
    if name == 'rigids':
        return jax_losses.diffusion_rigids_loss(
            batch, heads['folding'], lc.diffusion_rigids.config)
    if name == 'seq':
        return jax_losses.diffusion_seq_loss(
            batch, heads['sequence_module'], lc.diffusion_seq.config)
    if name == 'folding':
        return jax_losses.folding_loss(batch, heads['folding'],
                                       lc.folding.config, L_AB)
    if name == 'violation':
        return jax_losses.violation_loss(batch, heads['folding'],
                                         lc.folding.config)
    if name == 'distogram':
        return jax_losses.distogram_loss(batch, heads['distogram'],
                                         lc.distogram.config)
    if name == 'plddt':
        return jax_losses.predicted_lddt_loss(
            batch, heads['predicted_lddt'], heads['folding'],
            lc.predicted_lddt.config)
    out = jax_losses.total_loss(batch, {'heads': heads}, lc, L_AB)
    return dict(out['metrics'], loss=out['loss'])


def _port_call(name, pcfg, batch, preds):
    outputs = _outputs(preds, Rigid, torch.linspace(
        2.3125, 21.6875, 63))
    heads = outputs['heads']
    lc = pcfg.loss
    if name == 'rigids':
        return port_losses.diffusion_rigids_loss(
            batch, heads['folding'], lc.diffusion_rigids.config)
    if name == 'seq':
        return port_losses.diffusion_seq_loss(
            batch, heads['sequence_module'], lc.diffusion_seq.config)
    if name == 'folding':
        return port_losses.folding_loss(batch, heads['folding'],
                                        lc.folding.config, L_AB)
    if name == 'violation':
        return port_losses.violation_loss(batch, heads['folding'],
                                          lc.folding.config)
    if name == 'distogram':
        return port_losses.distogram_loss(batch, heads['distogram'],
                                          lc.distogram.config)
    if name == 'plddt':
        return port_losses.predicted_lddt_loss(
            batch, heads['predicted_lddt'], heads['folding'],
            lc.predicted_lddt.config)
    out = port_losses.total_loss(batch, outputs, lc, L_AB)
    return dict(out['metrics'], loss=out['loss'])


NAMES = ['rigids', 'seq', 'folding', 'violation', 'distogram', 'plddt',
         'total']
# Per example t: inside every gate; then one example past the rotation-angle
# threshold (0.2) and one past the structure gate (0.25).
T_CASES = {'all_gates': [0.1, 0.15], 'mixed_gates': [0.22, 0.6]}


@pytest.fixture(scope='module')
def jax_fns(base):
    """One jitted value-and-grad per loss and `exact_elbo` setting."""
    cfg = base[0]
    fns = {}
    for exact in (False, True):
        c = copy.deepcopy(cfg)
        with c.unlocked():
            c.loss.diffusion_seq.config.exact_elbo = exact
        for name in NAMES:
            def f(preds, batch, name=name, c=c):
                out = _jax_call(name, c, batch, preds)
                return out['loss'], out
            fns[(name, exact)] = jax.jit(jax.value_and_grad(f, has_aux=True))
    return fns


def _case(base, t_case, reverted=False):
    """The batch at the case's t.  Each example's forward jump lands on
    its first diffused site (x_t differs from the network's x_tilde
    there), or with `reverted`, example 0's is undone (x_t == x_tilde)."""
    cfg, batch, preds = base
    batch = dict(batch)
    batch['t'] = jnp.asarray(T_CASES[t_case], jnp.float32)
    seq_t = np.asarray(batch['seq_t'])
    seq_xt = seq_t.copy()
    diffused = (1 - np.asarray(batch['fixed_mask'])) * np.asarray(
        batch['mask'])
    for i in range(seq_t.shape[0]):
        site = int(np.argmax(diffused[i]))
        assert diffused[i, site] > 0
        seq_xt[i, site] = (seq_t[i, site] + 1) % 20
    if reverted:
        seq_xt[0] = seq_t[0]
    batch['seq_xt'] = jnp.asarray(seq_xt)
    return cfg, batch, preds


def _compare(jax_fns, base, name, exact, t_case, reverted=False):
    cfg, batch, preds = _case(base, t_case, reverted)
    (_, want), jgrad = jax_fns[(name, exact)](
        jax.tree.map(jnp.asarray, preds), batch)
    pcfg = port_config.tiny_model_config()
    pcfg.loss.diffusion_seq.config.exact_elbo = exact
    tp = {k: ([(torch.tensor(r, requires_grad=True),
                torch.tensor(tr, requires_grad=True)) for r, tr in v]
              if k == 'traj' else torch.tensor(v, requires_grad=True))
          for k, v in preds.items()}
    got = _port_call(name, pcfg, _port_batch(batch), tp)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert np.all(np.isfinite(g)), (name, k)
        np.testing.assert_allclose(g, w, rtol=VALUE_RTOL, atol=1e-7,
                                   err_msg=f'{name}/{k}')
    got['loss'].backward()
    checked = 0
    for k, w in jgrad.items():
        pairs = (zip([x for rt in tp['traj'] for x in rt],
                     [x for rt in w for x in rt]) if k == 'traj'
                 else [(tp[k], w)])
        for pt, jg in pairs:
            jg = np.asarray(jg)
            pg = (pt.grad.numpy() if pt.grad is not None
                  else np.zeros_like(jg))
            assert np.all(np.isfinite(pg)), (name, k)
            if np.linalg.norm(jg) == 0:
                assert np.linalg.norm(pg) == 0, (name, k)
                continue
            assert _rel(pg, jg) <= GRAD_RTOL, (name, k, _rel(pg, jg))
            checked += 1
    assert checked > 0, name
    return got


@pytest.mark.parametrize('t_case', list(T_CASES))
@pytest.mark.parametrize('name', NAMES)
def test_loss_matches_jax(jax_fns, base, name, t_case):
    """Values to 1e-5 relative, gradients to 1e-4 relative, with the
    surrogate sequence loss."""
    _compare(jax_fns, base, name, False, t_case)


@pytest.mark.parametrize('name', ['seq', 'total'])
def test_exact_elbo_matches_jax(jax_fns, base, name):
    got = _compare(jax_fns, base, name, True, 'all_gates')
    key = 'elbo_jump' if name == 'seq' else 'seq/elbo_jump'
    assert float(got[key].detach()) != 0.0


def test_reverted_corruption_has_no_jump(jax_fns, base):
    """Example 0 with its forward jump reverted: its jump term is 0 and
    every value and gradient finite, as in the JAX package."""
    got = _compare(jax_fns, base, 'seq', True, 'all_gates', reverted=True)
    for v in got.values():
        assert torch.isfinite(torch.as_tensor(v)).all()
    cfg, batch, _ = _case(base, 'all_gates', reverted=True)
    pb = _port_batch(batch)
    logits = torch.zeros(pb['seq'].shape + (20,))
    one = port_losses.ctmc_elbo_terms(
        {k: v[:1] for k, v in pb.items() if torch.is_tensor(v)},
        torch.log_softmax(logits[:1], -1), 1e-9)
    assert float(one['jump']) == 0.0
    assert np.isfinite(float(one['elbo']))
