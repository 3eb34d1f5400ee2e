"""The port's model in train() mode against the JAX package's training
forward, and the laws of its training pieces.

* Whole-model gradients: the tiny model with bridged dense random weights
  on a batch noised by the JAX features (mode 'optimize', t 0.1), dropout
  rates 0 in both.  JAX runs `deterministic=False`, `compute_loss=True`,
  one recycle pass, under `two_pass_layer_norm()` as its trainer does; the
  port runs `Trainer.loss_and_grads` in train() mode.  `total` and every
  metric agree to 1e-5 relative; every parameter's gradient, mapped by
  name through the weight bridge, to ||g_port - g_jax|| <= 1e-3 ||g_jax||
  + 1e-7.  The JAX gradient is compiled once for the file.
* In train() mode no kernel wrapper is called, with the kernel routes
  forced on the CPU (as `test_torch_modules._force_kernel_route` forces
  them) in the default and the opt-in flag configurations; in eval mode
  the same forcing does reach them.
* SpatialDepthWiseInception: the seq attention, the triangle attention and
  the triangle multiplication with `inp_kernels` against the JAX modules
  with bridged weights, to 1e-5, in eval and in train() mode (the cases
  of tests/test_sdwi.py); the tiny model with `inp_kernels` trains.
* The training step: an overfit check (the same batch and generator seed
  every step, the loss falls over 6 steps) and an ESM-conditioned step on
  a 2-layer ESM2 (its parameters unchanged and without gradient, the
  trunk and the learned layer weights moved).
* Laws: shared dropout, the train-mode features, the two-pass LayerNorm.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import features as jax_features
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models import modules as jax_modules
from abx_tpu.models import seqformer as jax_seqformer
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.train import losses as jax_losses
from abx_tpu_torch import config as port_config
from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data import features as port_features
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models import ipa as port_ipa
from abx_tpu_torch.models import modules as port_modules
from abx_tpu_torch.models import seqformer as port_seqformer
from abx_tpu_torch.models.network import ScoreNetworkIteration, zero_prev
from abx_tpu_torch.ops import (gate_proj, ipa_attend, ipa_attention,
                               pair_bias, recycle_embed, registry, transition,
                               tri_attention, tri_mult, triangle)
from abx_tpu_torch.train.trainer import TrainConfig, Trainer
from abx_tpu_torch.utils import params as params_lib
from tests.test_torch_modules import L_AB, L_AG, _dense, _feats, _jtree, n, t
from tests.test_torch_train_losses import _port_batch

METRIC_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-7
SDWI_TOL = dict(rtol=0, atol=1e-5)
BLOCKS = ('seq_attention_with_pair_bias', 'seq_transition',
          'outer_product_mean', 'triangle_multiplication_outgoing',
          'triangle_multiplication_incoming',
          'triangle_attention_starting_node',
          'triangle_attention_ending_node', 'pair_transition')


def _no_dropout(cfg):
    sf = cfg.model.embeddings_and_seqformer.seqformer
    for name in BLOCKS:
        sf[name]['dropout_rate'] = 0.0
    cfg.model.heads.diffusion_module.IPA['dropout'] = 0.0
    return cfg


def _jax_batch(seed=0, key=1):
    cfg = _no_dropout_jax()
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    feats = {k: jnp.asarray(v) for k, v in _feats(seed).items()}
    batch = jax_features.FeatureBuilder(is_training=True)(feats)
    batch = jax_features.make_diffuser_features(
        batch, diffuser=jdiff, generate_area='H3', key=jax.random.PRNGKey(key),
        mode='optimize', t_value=0.1, is_training=True)
    return cfg, jdiff, jax_features.make_static_pair_features(batch)


def _no_dropout_jax():
    cfg = jax_config.tiny_model_config()
    with cfg.unlocked():
        _no_dropout(cfg)
    return cfg


def _port_model(pcfg, tree=None):
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, L_AB)
    if tree is not None:
        params_lib.load_flax_params(pm, tree)
    return pm, pdiff


def _port_train_batch(jbatch, pcfg):
    pb = _port_batch(jbatch)
    b, l = pb['seq'].shape
    pb.update(zero_prev(b, l, pcfg.model))
    return pb


# --- whole-model gradients -------------------------------------------------

@pytest.fixture(scope='module')
def jax_grads():
    cfg, jdiff, batch = _jax_batch()
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=L_AB)
    tree = _dense(jm, 21, batch, compute_loss=True)

    def loss_fn(params):
        with jax_modules.two_pass_layer_norm():
            out = jm.apply(params, batch, compute_loss=True,
                           deterministic=False, num_recycle=1,
                           rngs={'dropout': jax.random.PRNGKey(0)})
            res = jax_losses.total_loss(batch, out, cfg.loss, L_AB)
        return res['loss'], res['metrics']
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(tree):
        (_, metrics), grads = grad_fn(_jtree(tree))
        return jax.tree.map(np.asarray, metrics), \
            params_lib.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    return (tree, batch) + run(tree) + (run,)


def test_training_loss_and_gradients_match_jax(jax_grads):
    tree, batch, want, want_grads, _ = jax_grads
    pcfg = _no_dropout(port_config.tiny_model_config())
    pm, pdiff = _port_model(pcfg, tree)
    trainer = Trainer(pm, pdiff, pcfg.model, pcfg.loss)
    got = trainer.loss_and_grads(_port_train_batch(batch, pcfg), 1, None)
    assert pm.training
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    named = dict(pm.named_parameters())
    assert set(named) == set(want_grads)
    worst = []
    for k, wg in want_grads.items():
        g = named[k].grad
        g = np.zeros(wg.shape, np.float32) if g is None else n(g)
        d = np.linalg.norm(g - n(wg))
        bound = GRAD_RTOL * np.linalg.norm(n(wg)) + GRAD_ATOL
        worst.append((d / bound, k))
        assert np.all(np.isfinite(g)), k
        assert d <= bound, (k, d, np.linalg.norm(n(wg)))
    # The comparison is not vacuous: most parameters receive gradient.
    nonzero = sum(np.linalg.norm(n(g)) > 0 for g in want_grads.values())
    assert nonzero > 0.8 * len(want_grads), nonzero


def _zero_affine_update(tree):
    """`tree` with the IPA's rigid update zeroed, as the AF2 init ('final':
    zeros) leaves it."""
    def go(d, path=()):
        return {k: (go(v, path + (k,)) if isinstance(v, dict)
                    else (np.zeros_like(v) if 'affine_update' in path else v))
                for k, v in d.items()}
    return go(tree)


def _top_leaves(grads, k=2):
    norms = {name: float(np.linalg.norm(n(g))) for name, g in grads.items()
             if g is not None}
    return sorted(norms, key=norms.get, reverse=True)[:k], norms


def test_first_step_gradient_at_the_af2_init_is_the_references(jax_grads):
    """At the AF2 init the rigid update is zero, so the predicted rotation
    score is rounding noise and the loss's axis term, score / (|score| +
    1e-6), magnifies it: the JAX trainer's first gradient is dominated by
    `affine_update`, by orders of magnitude, and so is the port's.  The
    values themselves are decided by rounding and are not compared."""
    tree, batch, _, _, run = jax_grads
    tree = _zero_affine_update(tree)
    _, want_grads = run(tree)
    pcfg = _no_dropout(port_config.tiny_model_config())
    pm, pdiff = _port_model(pcfg, tree)
    Trainer(pm, pdiff, pcfg.model, pcfg.loss).loss_and_grads(
        _port_train_batch(batch, pcfg), 1, None)
    leaf = ['diffusion_module.affine_update.weight',
            'diffusion_module.affine_update.bias']
    for grads in (want_grads, {k: p.grad for k, p in pm.named_parameters()}):
        top, norms = _top_leaves(grads)
        assert top == leaf, top
        rest = max(v for k, v in norms.items() if k not in leaf)
        assert norms[leaf[0]] > 1e4 * rest, (norms[leaf[0]], rest)
    # The runner's init (`reset_parameters`) zeroes the same layer.
    port_modules.reset_parameters(pm, 0)
    assert not pm.diffusion_module.affine_update.weight.any()


# --- no kernel route in training -------------------------------------------

WRAPPERS = (
    (port_seqformer, 'pair_bias_proj', pair_bias.pair_bias_proj_plain),
    (port_seqformer, 'triangle_attention_packed',
     tri_attention.triangle_attention_packed_plain),
    (port_seqformer, 'fused_transition', transition.fused_transition_plain),
    (port_seqformer, 'tri_mult_pre', tri_mult.tri_mult_pre_plain),
    (port_seqformer, 'tri_mult_post', tri_mult.tri_mult_post_plain),
    (port_seqformer, 'recycle_embed', recycle_embed.recycle_embed_plain),
    (port_ipa, 'ipa_attention', ipa_attention.ipa_attention_plain),
    (port_seqformer, 'gate_proj_residual',
     gate_proj.gate_proj_residual_plain),
    (port_seqformer, 'tri_mult_post_gatefold',
     tri_mult.tri_mult_post_gatefold_plain),
    (triangle, 'triangle_multiply_kernel', triangle.triangle_multiply_einsum),
    (port_ipa, 'ipa_pair_attend', ipa_attend.ipa_pair_attend_plain))
OPT_IN = {'ABX_FUSED_IPA_ATTN': '0', 'ABX_IPA_ATTEND': '1',
          'ABX_PALLAS_TRIANGLE': '1', 'ABX_TRIMULT_GATEFOLD': '1',
          'ABX_TRI_ATTN_LN_FOLD': '0', 'ABX_GATE_PROJ_KERNEL': '1'}


@pytest.mark.parametrize('flags', ['default', 'opt_in'])
def test_train_mode_calls_no_kernel_wrapper(monkeypatch, jax_grads, flags):
    """Kernel routes forced on the CPU; each wrapper swapped for a spy that
    records the call and runs the plain version.  A train() step with its
    backward records none; the same model in eval mode records calls."""
    tree, batch, _, _, _ = jax_grads
    if flags == 'opt_in':
        for k, v in OPT_IN.items():
            monkeypatch.setenv(k, v)
    monkeypatch.setattr(registry, 'on_device', lambda x: True)
    calls = []
    for module, name, plain in WRAPPERS:
        def spy(*args, _name=name, _plain=plain, packed=None, **kw):
            calls.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(module, name, spy)
    pcfg = port_config.tiny_model_config()
    pm, pdiff = _port_model(pcfg, tree)
    pb = _port_train_batch(batch, pcfg)
    trainer = Trainer(pm, pdiff, pcfg.model, pcfg.loss)
    metrics = trainer.loss_and_grads(pb, 1, torch.Generator().manual_seed(0))
    assert calls == [], sorted(set(calls))
    assert np.isfinite(float(metrics['total']))
    pm.eval()
    with torch.no_grad():
        pm(pb, compute_loss=True)
    assert calls, 'the forced kernel route reached no wrapper in eval mode'


# --- SpatialDepthWiseInception ---------------------------------------------

def _sdwi_case(kind, orientation):
    rs = np.random.RandomState({'seq': 1, 'tri_attn': 2, 'tri_mul': 3}[kind])
    b, l, cs, cp, h, nc = 2, 6, 16, 12, 4, 8
    cfg = dict(num_head=h, inp_kernels=[1, 3], orientation=orientation,
               shared_dropout=kind == 'seq', dropout_rate=0.0, gating=True,
               num_intermediate_channel=nc)
    pair = rs.randn(b, l, l, cp).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[1, -2:] = 0.0
    seq = rs.randn(b, l, cs).astype(np.float32)
    return cfg, seq, pair, mask


def _sdwi_modules(kind, cfg, seq, pair):
    import ml_collections
    jcfg = ml_collections.ConfigDict(cfg)
    pcfg = port_config.Cfg(cfg)
    if kind == 'seq':
        return (jax_seqformer.SeqAttentionWithPairBias(jcfg),
                port_seqformer.SeqAttentionWithPairBias(
                    pcfg, seq.shape[-1], pair.shape[-1]))
    if kind == 'tri_attn':
        return (jax_seqformer.TriangleAttention(jcfg),
                port_seqformer.TriangleAttention(pcfg, pair.shape[-1]))
    return (jax_seqformer.TriangleMultiplication(jcfg),
            port_seqformer.TriangleMultiplication(pcfg, pair.shape[-1]))


SDWI_CASES = [('seq', 'per_row'), ('tri_attn', 'per_row'),
              ('tri_attn', 'per_column'), ('tri_mul', 'per_row'),
              ('tri_mul', 'per_column')]


@pytest.mark.parametrize('mode', ['eval', 'train'])
@pytest.mark.parametrize('kind,orientation', SDWI_CASES)
def test_sdwi_modules_match_jax(kind, orientation, mode):
    cfg, seq, pair, mask = _sdwi_case(kind, orientation)
    jm, pm = _sdwi_modules(kind, cfg, seq, pair)
    jargs = {'seq': (seq, pair, mask)}.get(kind, (pair, mask))
    det = {} if kind == 'tri_mul' else {'deterministic': mode == 'eval'}
    tree = _dense(jm, 40, *jargs, **det)
    ctx = (jax_modules.two_pass_layer_norm() if mode == 'train'
           else contextlib.nullcontext())
    with ctx:
        want = jm.apply(_jtree(tree), *jargs, **det)
    params_lib.load_flax_params(pm, tree)
    assert any('inp_' in k and 'conv0_weight' in k
               for k in pm.state_dict()), sorted(pm.state_dict())
    pm.train(mode == 'train')
    got = pm(*(t(a) for a in jargs))
    np.testing.assert_allclose(n(got), np.asarray(want), **SDWI_TOL)


def test_sdwi_model_runs_in_inference_and_training():
    """The tiny model with inp_kernels on every attention and triangle
    multiplication: an eval forward and a train() step are finite, and
    the convolution weights get gradient."""
    pcfg = port_config.tiny_model_config()
    sf = pcfg.model.embeddings_and_seqformer.seqformer
    for name in ('seq_attention_with_pair_bias',
                 'triangle_attention_starting_node',
                 'triangle_attention_ending_node',
                 'triangle_multiplication_outgoing',
                 'triangle_multiplication_incoming'):
        sf[name]['inp_kernels'] = [1, 3]
        sf[name].setdefault('num_head', 4)
    _, _, batch = _jax_batch()
    pm, pdiff = _port_model(pcfg)
    port_modules.reset_parameters(pm, 0)
    with torch.no_grad():
        for k, p in pm.named_parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(len(k))))
    pb = _port_train_batch(batch, pcfg)
    pm.eval()
    with torch.no_grad():
        out = pm(pb)
    assert torch.isfinite(out['heads']['folding']['rigids']).all()
    trainer = Trainer(pm, pdiff, pcfg.model, pcfg.loss)
    metrics = trainer.loss_and_grads(pb, 1, torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics['total']))
    convs = [p.grad for k, p in pm.named_parameters() if 'conv0_weight' in k]
    assert len(convs) == 3 * 3 + 2 * 2   # q/k/v x 3 attentions, l/r x 2
    assert all(g is not None and torch.isfinite(g).all() for g in convs)
    assert sum(float(g.abs().sum()) > 0 for g in convs) >= len(convs) - 2


# --- the training step -----------------------------------------------------

def _numpy_feats(seed=0):
    return {k: np.asarray(v) for k, v in _feats(seed).items()}


def test_loss_decreases_on_overfit():
    """Same batch and generator seed every step (the same noising, recycle
    depth and dropout): the loss falls over 6 steps."""
    pcfg = port_config.tiny_model_config()
    pm, pdiff = _port_model(pcfg)
    port_modules.reset_parameters(pm, 0)
    trainer = Trainer(pm, pdiff, pcfg.model, pcfg.loss,
                      TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                  generate_area='H3'))
    state = trainer.init_state()
    feats = _numpy_feats()
    losses = []
    for _ in range(6):
        metrics = trainer.step(state, feats, torch.Generator().manual_seed(3))
        losses.append(float(metrics['total']))
        assert np.isfinite(float(metrics['grad_norm']))
    assert state.step == 6
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_esm_conditioned_train_step():
    """Frozen 2-layer ESM2 inside every trunk pass: the loss is finite, no
    ESM parameter has a gradient or moves, and the trunk (the ESM
    projection included) and the learned layer weights move."""
    pcfg = port_config.tiny_model_config()
    es = pcfg.model.embeddings_and_seqformer.esm
    es.enabled = True
    es.num_layers = port_esm.ESM2Config.tiny().num_layers
    es.embed_channel = port_esm.ESM2Config.tiny().embed_dim
    pm, pdiff = _port_model(pcfg)
    # Dense weights: AF2's zero 'final' inits would block the gradient of
    # the layers before them.
    params_lib.load_flax_params(pm, params_lib.dense_random_tree(
        params_lib.state_dict_tree(pm), seed=6, scale=0.5))
    esm = port_esm.AntibodyESM(port_esm.ESM2Config.tiny(), L_AB,
                               sep_pad_num=4, dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in esm.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    esm.requires_grad_(False).eval()
    esm_before = {k: v.clone() for k, v in esm.state_dict().items()}
    trunk_before = {k: v.detach().clone() for k, v in pm.named_parameters()}
    trainer = Trainer(pm, pdiff, pcfg.model, pcfg.loss,
                      TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                  generate_area='H3'), esm=esm)
    state = trainer.init_state()
    feats = _numpy_feats(2)
    feats['heavy_len'] = np.asarray([8, 8], np.int32)
    feats['light_len'] = np.asarray([6, 6], np.int32)
    gen = torch.Generator().manual_seed(5)
    batch = trainer.prepare_batch(feats, gen)
    metrics = trainer.loss_and_grads(batch, 1, gen)
    assert np.isfinite(float(metrics['total']))
    assert all(p.grad is None for p in esm.parameters())
    lw = pm.seqformer.esm_embed_weights
    assert lw.grad is not None and torch.isfinite(lw.grad).all()
    assert float(lw.grad.abs().sum()) > 0
    trainer.apply_update(state)
    trainer.apply_update(state)   # the first update is at lr schedule(0)
    for k, v in esm.state_dict().items():
        assert torch.equal(v, esm_before[k]), k
    moved = {k for k, p in pm.named_parameters()
             if not torch.equal(p.detach(), trunk_before[k])}
    assert 'seqformer.esm_embed_weights' in moved
    assert any(k.startswith('seqformer.proj_esm_embed') for k in moved)
    assert len(moved) > 0.8 * len(trunk_before)


# --- laws ------------------------------------------------------------------

def test_shared_dropout_law():
    x = torch.ones(4, 64, 48, 3)
    rate = 0.25
    y = port_modules.shared_dropout(x, rate, torch.Generator().manual_seed(0),
                                    broadcast_dim=1)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    # The mask is shared along the broadcast axis.
    assert torch.equal(kept, kept[:, :1].expand_as(kept))
    share = kept[:, 0].float().mean().item()
    assert abs(share - (1 - rate)) < 0.03, share
    free = port_modules.shared_dropout(x, rate,
                                       torch.Generator().manual_seed(0))
    assert not torch.equal(free != 0, (free != 0)[:, :1].expand_as(free))
    assert port_modules.shared_dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match='Generator'):
        port_modules.shared_dropout(x, rate, None)


def _port_feats(seed=0):
    pb = port_features.FeatureBuilder(is_training=True)(
        {k: torch.tensor(v) if v.dtype.kind == 'f'
         else torch.tensor(v.astype(np.int64))
         for k, v in _numpy_feats(seed).items()})
    return pb


def test_train_mode_features_law():
    pcfg = port_config.tiny_model_config()
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    for seed in range(4):
        pb = _port_feats(seed)
        out = port_features.make_diffuser_features(
            dict(pb), diffuser=pdiff, generate_area='cdr',
            generator=torch.Generator().manual_seed(seed), mode='train',
            is_training=True)
        assert ((out['t'] >= 0.01) & (out['t'] < 1.0)).all()
        anchor = pb['anchor_flag']
        diffused = out['diffused_mask'][:, :L_AB]
        for b in range(anchor.shape[0]):
            inside = torch.zeros(L_AB, dtype=torch.bool)
            for enum in rc.cdr_str_to_enum.values():
                idx = torch.nonzero(anchor[b] == enum)[:, 0]
                if len(idx):
                    # Jitter [-1, +2] at each end, then slice(first+1,
                    # last-1): every diffused residue in [first-1, last].
                    inside[max(int(idx[0]) - 1, 0):int(idx[-1]) + 1] = True
            assert not (diffused[b].bool() & ~inside).any()
        assert (out['diffused_mask'][:, L_AB:] == 0).all()
        # With t given (the one drawn, in the same order from the same
        # generator), the outputs are the forward marginal's.
        g = torch.Generator().manual_seed(seed)
        mask = port_features.select_cdrs_mask(
            anchor, L_AB, list(rc.cdr_str_to_enum.values()), pb['mask'],
            generator=g) * pb['mask'].long()
        t_vec = 0.01 + 0.99 * torch.rand((anchor.shape[0],), generator=g)
        want = pdiff.forward_marginal(
            g, pb['rigidgroups_gt_frames'][..., 0].to_tensor7(),
            pb['seq'].long(), t_vec, mask)
        assert torch.equal(out['diffused_mask'], mask)
        assert torch.equal(out['t'], t_vec)
        for k, v in want.items():
            assert torch.equal(out[k], v), k


def test_two_pass_layer_norm_at_large_mean():
    """|mean| >> std: the two-pass variance (train() mode) matches the f64
    reference where the one-pass form (eval mode) loses it, as
    tests/test_model.py shows for the JAX package."""
    rng = np.random.RandomState(0)
    x = (1e4 + 0.1 * rng.randn(4, 256)).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    want = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(-1, keepdims=True)
                                  + 1e-5)
    ln = port_modules.LayerNorm(256)
    one = n(ln.eval()(torch.tensor(x)))
    two = n(ln.train()(torch.tensor(x)))
    # The JAX package's bars: the two-pass residual is the f32 mean's own
    # error (~0.01); the one-pass form is off by ~90.
    err_one = np.abs(one - want).max()
    err_two = np.abs(two - want).max()
    assert err_two < 0.05, err_two
    assert err_two < err_one / 100, (err_one, err_two)
