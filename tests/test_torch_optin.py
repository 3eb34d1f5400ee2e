"""The opt-in kernel configuration of the port against the JAX package.

The opt-in configuration is the JAX package's opt-in kernel flags, with
the triangle-attention LN-fold off:

    ABX_FUSED_IPA_ATTN=0 ABX_IPA_ATTEND=1 ABX_PALLAS_TRIANGLE=1
    ABX_TRIMULT_GATEFOLD=1 ABX_TRI_ATTN_LN_FOLD=0 ABX_GATE_PROJ_KERNEL=1

Kernels: the plain versions of `ipa_pair_attend`, `triangle_multiply`
(both orientations, ragged L), `tri_mult_post_gatefold`,
`gate_proj_residual` and `tri_mult_pre(emit_fgate=False)` against the JAX
`*_reference` functions and the Pallas kernels in interpret mode, in f32,
to 1e-4 * max|ref|.

Routes: with `registry.on_device` forced true and every kernel wrapper
swapped for its plain version (counted), each of the five mirrored flags
sends the modules down the route the JAX package takes:
`ABX_TRIMULT_C_MAJOR=1` takes the channel-major pre / post before the
gate-fold, and not with `ABX_PALLAS_TRIANGLE=1`.  The registry mirrors the
JAX flags and defaults, `ABX_TRI_ATTN_BF16_EXP` included.  The port's full
network forward under the opt-in configuration and under
`ABX_TRIMULT_C_MAJOR=1` is held to the JAX network in
tests/test_torch_modules.py
(`test_opt_in_forward_with_recycling_matches_jax`,
`test_c_major_forward_with_recycling_matches_jax`).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.ops.gate_proj import gate_proj_residual as jax_gate_proj
from abx_tpu.ops.gate_proj import gate_proj_residual_reference
from abx_tpu.ops.ipa_attend import ipa_pair_attend as jax_ipa_attend
from abx_tpu.ops.ipa_attend import ipa_pair_attend_reference
from abx_tpu.ops.tri_mult import tri_mult_post_gatefold as jax_gatefold
from abx_tpu.ops.tri_mult import tri_mult_post_gatefold_reference
from abx_tpu.ops.tri_mult import tri_mult_pre as jax_tri_mult_pre
from abx_tpu.ops.tri_mult import tri_mult_pre_reference
from abx_tpu.ops.triangle import (triangle_multiply_einsum,
                                  triangle_multiply_pallas)
from abx_tpu_torch import config as port_config
from abx_tpu_torch.data import features as port_features
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models import ipa as port_ipa
from abx_tpu_torch.models import seqformer as port_seqformer
from abx_tpu_torch.models.network import ScoreNetworkIteration, zero_prev
from abx_tpu_torch.ops import ipa_attend as ipa_attend_op
from abx_tpu_torch.ops import registry
from abx_tpu_torch.ops import tri_mult as tri_mult_op
from abx_tpu_torch.ops import triangle as triangle_op
from abx_tpu_torch.utils import params as params_lib
from tests.test_torch_kernels import (BF16_SHARE, BF16_STEPS,
                                      TRI_MULT_SHAPES, _gate_proj_case,
                                      _gate_proj_port, _gatefold_case,
                                      _gatefold_port, _ipa_attend_case,
                                      _no_fgate, _tri_mult_pre_case,
                                      _triangle_case, bf16_agree, t)
from tests.test_torch_modules import (L_AB, L_AG, OPT_IN, _feats,
                                      _force_kernel_route)

REL_TOL = 1e-4   # max|plain - JAX| <= REL_TOL * max|JAX|, f32


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), err


def _jnp(args):
    return [jnp.asarray(a) for a in args]


# --- kernels: plain version vs JAX reference and interpret-mode Pallas ------

@pytest.mark.parametrize('shape', [(2, 9, 9, 16, 24), (1, 5, 11, 40, 8)])
def test_gate_proj_plain_matches_jax(shape):
    """(b, r, l, hd, c), r != l and odd."""
    args = _gate_proj_case(21, *shape)
    got = _gate_proj_port(args).numpy()
    _close(got, gate_proj_residual_reference(*_jnp(args)))
    _close(got, jax_gate_proj(*_jnp(args), row_block=4, interpret=True))


def test_tri_mult_post_gatefold_plain_matches_jax():
    """nc = 72: above one 64-channel chunk, odd L."""
    b, l, c, nc = TRI_MULT_SHAPES[1]
    args = _gatefold_case(22, b, l, nc, c)
    got = _gatefold_port(args).numpy()
    _close(got, tri_mult_post_gatefold_reference(*_jnp(args)))
    _close(got, jax_gatefold(*_jnp(args), row_block=4, interpret=True))


@pytest.mark.parametrize('kind,shape', [
    ('gatefold', (1, 11, 24, 72)), ('gatefold', (2, 9, 16, 8)),
    ('gate_proj', (2, 9, 9, 16, 24)), ('gate_proj', (1, 5, 11, 40, 8)),
    ('ipa_pair_attend', (2, 12, 11, 24)),
    ('ipa_pair_attend', (1, 16, 13, 40))])
def test_opt_in_plain_matches_pallas_interpret_in_bf16(kind, shape):
    """tri_mult_post_gatefold, gate_proj_residual and ipa_pair_attend (f32
    attn, bf16 pair) in bf16 against the Pallas kernels in interpret mode:
    both products (or the projection) of values in the input dtype summed
    in f32, LN(y), LN_x(res), z = y * sigmoid(gate) and attn rounded to the
    input dtype, the gate-fold's gate kept in f32, one rounding of the
    output; at most BF16_SHARE of the outputs differ, by at most BF16_STEPS
    (tests/test_torch_kernels.py)."""
    if kind == 'gatefold':
        b, l, c, nc = shape
        args = _gatefold_case(27, b, l, nc, c)
        low = {0, 9}
        fn, jax_fn = _gatefold_port, jax_gatefold
    elif kind == 'ipa_pair_attend':
        args = _ipa_attend_case(29, *shape)
        low = {1}

        def fn(args, dtype):
            return ipa_attend_op.ipa_pair_attend_plain(t(args[0]),
                                                       t(args[1]).to(dtype))
        jax_fn = jax_ipa_attend
    else:
        args = _gate_proj_case(28, *shape)
        low = {0, 1, 4}
        fn, jax_fn = _gate_proj_port, jax_gate_proj
    got = fn(args, dtype=torch.bfloat16)
    want = jax_fn(*[jnp.asarray(a, jnp.bfloat16) if i in low
                    else jnp.asarray(a) for i, a in enumerate(args)],
                  row_block=4, interpret=True)
    err, share = bf16_agree(got, torch.as_tensor(np.array(
        want.astype(jnp.float32))))
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


def test_tri_mult_pre_no_fgate_plain_matches_jax():
    """The emit_fgate=False variant: w without the final-gate columns; its
    left and right equal the reference's (which always has the gate)."""
    full = _tri_mult_pre_case(23, *TRI_MULT_SHAPES[1])
    x, s, lb, w, wb, mask = _no_fgate(full)
    got = tri_mult_op.tri_mult_pre_plain(t(x), t(s), t(lb), t(w.T), t(wb),
                                         t(mask), emit_fgate=False)
    assert len(got) == 2
    want_ref = tri_mult_pre_reference(*_jnp(full))[:2]
    want_kern = jax_tri_mult_pre(*_jnp((x, s, lb, w, wb, mask)),
                                 row_block=4, emit_fgate=False,
                                 interpret=True)
    for g, wr, wk in zip(got, want_ref, want_kern):
        _close(g.numpy(), wr)
        _close(g.numpy(), wk)


@pytest.mark.parametrize('shape', [(2, 3, 11, 16), (1, 12, 13, 8)])
def test_ipa_pair_attend_plain_matches_jax(shape):
    """(b, h, l, c), odd L."""
    attn, pair = _ipa_attend_case(24, *shape)
    got = ipa_attend_op.ipa_pair_attend_plain(t(attn), t(pair)).numpy()
    _close(got, ipa_pair_attend_reference(jnp.asarray(attn),
                                          jnp.asarray(pair)))
    _close(got, jax_ipa_attend(jnp.asarray(attn), jnp.asarray(pair),
                               row_block=4, interpret=True))


@pytest.mark.parametrize('per_row', [True, False])
@pytest.mark.parametrize('shape', [(2, 19, 8), (1, 13, 16), (1, 21, 20),
                                   (1, 37, 24)])
def test_triangle_multiply_plain_matches_jax(shape, per_row):
    """Ragged L: 19, 13, 21 and 37 against a tile of 8 in the Pallas
    kernel; C = 20, not a multiple of 8 (the kernel wrapper pads the input
    channels to whole 16-byte vectors), and C = 24 above one 16-channel
    block at a ragged L."""
    left, right = _triangle_case(25, *shape)
    got = triangle_op.triangle_multiply(t(left), t(right), per_row,
                                        use_pallas=True).numpy()
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    _close(got, triangle_multiply_einsum(jl, jr, per_row))
    _close(got, triangle_multiply_pallas(jl, jr, per_row=per_row, tile=8,
                                         interpret=True))


# --- routes: the flags send the modules where the JAX package goes ----------

COUNTED = {
    port_seqformer: ('tri_mult_pre', 'tri_mult_post',
                     'tri_mult_post_gatefold', 'gate_proj_residual',
                     'triangle_attention_packed', 'pair_bias_proj'),
    port_ipa: ('ipa_attention', 'ipa_pair_attend'),
    triangle_op: ('triangle_multiply_kernel',),
}


def _count_kernel_routes(monkeypatch):
    """_force_kernel_route, with each counted (plain) wrapper wrapped in a
    call counter; tri_mult_pre and tri_mult_post are counted per
    variant."""
    _force_kernel_route(monkeypatch)
    calls = collections.Counter()
    for module, names in COUNTED.items():
        for name in names:
            fn = getattr(module, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                key = _name
                if _name == 'tri_mult_pre' and not kw.get('emit_fgate', True):
                    key = 'tri_mult_pre_no_fgate'
                if kw.get('c_major') or kw.get('y_c_major'):
                    key = f'{_name}_c_major'
                calls[key] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture(scope='module')
def setup():
    """The port's network (tiny config, dense random weights) and one
    prepared batch, at L = 14 + 5."""
    pcfg = port_config.tiny_model_config()
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, L_AB).eval()
    params_lib.load_flax_params(pm, params_lib.dense_random_tree(
        params_lib.state_dict_tree(pm), seed=31, scale=0.5))
    pb = port_features.FeatureBuilder()(
        {k: torch.tensor(v) for k, v in _feats(30).items()})
    pb = port_features.make_diffuser_features(
        pb, diffuser=pdiff, generator=torch.Generator().manual_seed(3))
    pb = port_features.make_static_pair_features(pb)
    t_vec = torch.tensor([0.55, 0.3])
    rs, ts = pdiff.score_scaling(t_vec)
    pb.update(t=t_vec, rot_score_scaling=rs, trans_score_scaling=ts)
    pb.update(zero_prev(2, L_AB + L_AG, pcfg.model))
    return pm, pb


def _one_pass(setup):
    pm, pb = setup
    with torch.no_grad():
        return pm(pb)


def _set_flags(monkeypatch, flags):
    for k, v in flags.items():
        monkeypatch.setenv(k, v)


# The opt-in configuration without the contraction kernel, under which the
# channel-major route is reachable.
C_MAJOR_BASE = {**OPT_IN, 'ABX_PALLAS_TRIANGLE': '0'}


@pytest.mark.parametrize('flag,on,off', [
    ('ABX_PALLAS_TRIANGLE', {'triangle_multiply_kernel': 2},
     {'triangle_multiply_kernel': 0}),
    ('ABX_IPA_ATTEND', {'ipa_pair_attend': 2}, {'ipa_pair_attend': 0}),
    ('ABX_GATE_PROJ_KERNEL', {'gate_proj_residual': 2},
     {'gate_proj_residual': 0}),
    ('ABX_TRIMULT_GATEFOLD',
     {'tri_mult_pre_no_fgate': 2, 'tri_mult_pre': 0,
      'tri_mult_post_gatefold': 2, 'tri_mult_post': 0},
     {'tri_mult_pre_no_fgate': 0, 'tri_mult_pre': 2,
      'tri_mult_post_gatefold': 0, 'tri_mult_post': 2}),
    ('ABX_TRIMULT_C_MAJOR',
     {'tri_mult_pre_c_major': 2, 'tri_mult_post_c_major': 2,
      'tri_mult_pre': 0, 'tri_mult_post': 0, 'tri_mult_pre_no_fgate': 0,
      'tri_mult_post_gatefold': 0, 'triangle_multiply_kernel': 0},
     {'tri_mult_pre_c_major': 0, 'tri_mult_post_c_major': 0,
      'tri_mult_pre_no_fgate': 2, 'tri_mult_post_gatefold': 2}),
])
def test_forced_kernel_route_follows_each_flag(setup, monkeypatch, flag, on,
                                               off):
    """One trunk pass + structure module (tiny: 1 Seqformer block, 2 IPA
    layers), the other opt-in flags set so that the flag's route is
    reachable (for ABX_TRIMULT_C_MAJOR: the contraction kernel off); the
    counts are per pass."""
    calls = _count_kernel_routes(monkeypatch)
    _set_flags(monkeypatch, C_MAJOR_BASE if flag == 'ABX_TRIMULT_C_MAJOR'
               else OPT_IN)
    for value, want in (('1', on), ('0', off)):
        monkeypatch.setenv(flag, value)
        calls.clear()
        _one_pass(setup)
        got = {k: calls[k] for k in want}
        assert got == want, (flag, value, dict(calls))


def _jax_tri_attn_bf16_exp():
    """The JAX package reads ABX_TRI_ATTN_BF16_EXP inline, not through its
    registry (abx_tpu/ops/tri_attention.py, triangle_attention_packed and
    triangle_attention_packed_cols)."""
    import os
    return os.environ.get('ABX_TRI_ATTN_BF16_EXP', '1') == '1'


def test_registry_mirrors_the_jax_flags(monkeypatch):
    from abx_tpu.ops import registry as jax_registry
    for name in ('use_pallas_triangle', 'use_ipa_attend_kernel',
                 'use_gate_proj_kernel', 'use_trimult_gatefold',
                 'use_trimult_c_major', 'use_tri_attn_bf16_exp'):
        flag_fn = getattr(registry, name)
        jax_fn = (_jax_tri_attn_bf16_exp if name == 'use_tri_attn_bf16_exp'
                  else getattr(jax_registry, name))
        assert flag_fn() == jax_fn(), name          # same default
        for value in ('0', '1'):
            env = {'ABX_PALLAS_TRIANGLE': value, 'ABX_IPA_ATTEND': value,
                   'ABX_GATE_PROJ_KERNEL': value,
                   'ABX_TRIMULT_GATEFOLD': value,
                   'ABX_TRIMULT_C_MAJOR': value,
                   'ABX_TRI_ATTN_BF16_EXP': value}
            _set_flags(monkeypatch, env)
            assert flag_fn() == jax_fn() == (value == '1'), name
        for k in env:
            monkeypatch.delenv(k)


def test_c_major_on_the_kernel_route_raises(setup, monkeypatch):
    """Under ABX_TRIMULT_C_MAJOR=1 the kernel route raises nothing and goes
    where the JAX package goes: the channel-major pre / post win over
    ABX_TRIMULT_GATEFOLD, and with ABX_PALLAS_TRIANGLE=1 the natural
    route with the contraction kernel is taken (the gate-fold one when
    ABX_TRIMULT_GATEFOLD=1 too).  Counts per pass."""
    calls = _count_kernel_routes(monkeypatch)
    monkeypatch.setenv('ABX_TRIMULT_C_MAJOR', '1')
    for pallas, gatefold, want in (
            ('0', '1', {'tri_mult_pre_c_major': 2, 'tri_mult_post_c_major': 2,
                        'tri_mult_pre_no_fgate': 0,
                        'tri_mult_post_gatefold': 0,
                        'triangle_multiply_kernel': 0}),
            ('1', '0', {'tri_mult_pre': 2, 'tri_mult_post': 2,
                        'triangle_multiply_kernel': 2,
                        'tri_mult_pre_c_major': 0,
                        'tri_mult_post_c_major': 0}),
            ('1', '1', {'tri_mult_pre_no_fgate': 2,
                        'tri_mult_post_gatefold': 2,
                        'triangle_multiply_kernel': 2,
                        'tri_mult_pre_c_major': 0})):
        monkeypatch.setenv('ABX_PALLAS_TRIANGLE', pallas)
        monkeypatch.setenv('ABX_TRIMULT_GATEFOLD', gatefold)
        calls.clear()
        _one_pass(setup)
        got = {k: calls[k] for k in want}
        assert got == want, (pallas, gatefold, dict(calls))
