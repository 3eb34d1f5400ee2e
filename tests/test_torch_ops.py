"""The port's kernel modules against the JAX package.

For each of `triangle_attention_packed`, `pair_bias_proj`,
`fused_transition`, `ipa_attention`, `tri_mult_pre`, `tri_mult_post` and
`recycle_embed`, the port's plain PyTorch version
(what the wrapper runs on a CPU tensor) is held against the JAX
`*_reference` function and against the JAX Pallas kernel in interpret
mode, in f32 at small shapes with several heads, D=17, odd L, a partial
key mask and both orientations.  Tolerance: atol = rtol = 1e-4.

The case builders and the on-card half (kernel vs plain version) live in
tests/test_torch_kernels.py, which runs without jax.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from abx_tpu.ops.ipa_attention import ipa_attention as jax_ipa
from abx_tpu.ops.ipa_attention import ipa_attention_reference
from abx_tpu.ops.pair_bias import pair_bias_proj as jax_pair_bias
from abx_tpu.ops.pair_bias import pair_bias_proj_reference
from abx_tpu.ops.recycle_embed import recycle_embed as jax_recycle
from abx_tpu.ops.recycle_embed import recycle_embed_reference
from abx_tpu.ops.transition import fused_transition as jax_transition
from abx_tpu.ops.transition import fused_transition_reference
from abx_tpu.ops.tri_attention import triangle_attention_packed as jax_packed
from abx_tpu.ops.tri_attention import triangle_attention_packed_reference
from abx_tpu.ops.tri_mult import tri_mult_post as jax_tri_mult_post
from abx_tpu.ops.tri_mult import tri_mult_post_reference
from abx_tpu.ops.tri_mult import tri_mult_pre as jax_tri_mult_pre
from abx_tpu.ops.tri_mult import tri_mult_pre_reference
from abx_tpu_torch.ops import ipa_attention as ipa_op
from abx_tpu_torch.ops import pair_bias as pair_bias_op
from abx_tpu_torch.ops import recycle_embed as recycle_op
from abx_tpu_torch.ops import transition as transition_op
from abx_tpu_torch.ops import tri_mult as tri_mult_op
from tests.test_torch_kernels import (BF16_SHARE, BF16_STEPS,
                                     IPA_CANCEL_TOL, TRI_SHAPES, _cancel_err,
                                     _ipa_cancel_case, _ipa_cancel_inputs,
                                     _ipa_case, _ln_np, _pair_bias_case,
                                     _pair_bias_port, _recycle_case,
                                     _recycle_port, _transition_case,
                                     _transition_port, _tri_case,
                                     _tri_mult_post_case, _tri_mult_post_port,
                                     _tri_mult_pre_case, _tri_mult_pre_port,
                                     _tri_port, bf16_agree, t)

TOL = dict(rtol=1e-4, atol=1e-4)


# --- triangle_attention_packed ---------------------------------------------



@pytest.mark.parametrize('shape,orientation', [
    (s, o) for s in TRI_SHAPES for o in ('per_row', 'per_column')
    if s[1] > 1 or o == 'per_row'])
def test_tri_attention_plain_matches_jax_reference(shape, orientation):
    b, r, l, h, d = shape
    k = _tri_case(0, b, r, l, h, d, 2 * h * d - 3, orientation)
    wq, wk, wv, wg = k['w']
    ln_x = _ln_np(k['x'], k['scale'], k['lnb'])
    att = np.asarray(triangle_attention_packed_reference(
        jnp.asarray(ln_x), jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv),
        jnp.asarray(k['bias']), jnp.asarray(k['mask'])))
    gate = 1.0 / (1.0 + np.exp(-(ln_x @ wg + k['bg'])))
    want = k['res'] + (att * gate) @ k['wo'] + k['bo']
    np.testing.assert_allclose(_tri_port(k).numpy(), want, **TOL)
    # Without the LN / gate / out-proj options: the bare reference.
    want_bare = np.asarray(triangle_attention_packed_reference(
        jnp.asarray(k['x']), jnp.asarray(wq), jnp.asarray(wk),
        jnp.asarray(wv), jnp.asarray(k['bias']), jnp.asarray(k['mask'])))
    np.testing.assert_allclose(_tri_port(k, full=False).numpy(), want_bare,
                               **TOL)


@pytest.mark.parametrize('shape', TRI_SHAPES)
def test_tri_attention_plain_matches_pallas_interpret(shape):
    b, r, l, h, d = shape
    k = _tri_case(1, b, r, l, h, d, h * d, 'per_row')
    wq, wk, wv, wg = (jnp.asarray(w) for w in k['w'])
    got = np.asarray(jax_packed(
        jnp.asarray(k['x']), wq, wk, wv, jnp.asarray(k['bias']),
        jnp.asarray(k['mask']), row_block=1 if r == 1 else 4,
        ln=(jnp.asarray(k['scale']), jnp.asarray(k['lnb'])),
        gate=(wg, jnp.asarray(k['bg'])),
        out_proj=(jnp.asarray(k['wo']), jnp.asarray(k['bo'])),
        residual=jnp.asarray(k['res']), interpret=True))
    np.testing.assert_allclose(_tri_port(k).numpy(), got, **TOL)


# --- pair_bias_proj --------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 9, 9, 16, 4), (1, 13, 13, 24, 32),
                                   (2, 1, 11, 8, 3)])
def test_pair_bias_plain_matches_jax(shape):
    pair, scale, bias, w = _pair_bias_case(2, *shape)
    got = pair_bias_op.pair_bias_proj_plain(t(pair), t(scale), t(bias),
                                            t(w.T)).numpy()
    want = np.moveaxis(np.asarray(pair_bias_proj_reference(
        jnp.asarray(pair), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(w))), -1, -3)
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jax_pair_bias(
        jnp.asarray(pair), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(w), row_block=8, transpose_out=True, interpret=True))
    np.testing.assert_allclose(got, kern, **TOL)


# --- fused_transition ------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 7, 9, 16), (1, 11, 11, 24)])
def test_transition_plain_matches_jax(shape):
    x, s, lb, w1, b1, w2, b2 = _transition_case(3, *shape)
    got = transition_op.fused_transition_plain(
        t(x), t(s), t(lb), t(w1.T), t(b1), t(w2.T), t(b2)).numpy()
    args = [jnp.asarray(a) for a in (x, s, lb, w1, b1, w2, b2)]
    np.testing.assert_allclose(
        got, np.asarray(fused_transition_reference(*args)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_transition(*args, row_block=4, interpret=True)),
        **TOL)


# --- pair_bias_proj and fused_transition in bf16 ----------------------------
# The rounding points the Hopper kernels keep: the port's plain versions in
# bf16 against the Pallas kernels in interpret mode in bf16 (LN(x) and the
# hidden activations rounded to bf16, products summed in f32, one rounding
# of the output).  Tolerance: BF16_STEPS and BF16_SHARE
# (tests/test_torch_kernels.py, where the check is shown to tell a missed
# rounding point).

@pytest.mark.parametrize('shape', [(2, 9, 9, 16, 4), (1, 13, 13, 24, 32),
                                   (2, 8, 8, 64, 5)])
def test_pair_bias_plain_matches_pallas_interpret_in_bf16(shape):
    import torch
    case = _pair_bias_case(12, *shape)
    got = pair_bias_op.pair_bias_proj_plain(*_pair_bias_port(
        case, torch.bfloat16))
    pair, scale, bias, w = case
    want = np.array(jax_pair_bias(
        jnp.asarray(pair, jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(bias), jnp.asarray(w), row_block=8, transpose_out=True,
        interpret=True).astype(jnp.float32))
    err, share = bf16_agree(got, torch.as_tensor(want))
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


@pytest.mark.parametrize('shape', [(2, 7, 9, 16), (1, 11, 11, 24),
                                   (1, 8, 16, 64)])
def test_transition_plain_matches_pallas_interpret_in_bf16(shape):
    import torch
    case = _transition_case(13, *shape)
    got = transition_op.fused_transition_plain(*_transition_port(
        case, torch.bfloat16))
    args = [jnp.asarray(case[0], jnp.bfloat16)] + [jnp.asarray(a)
                                                   for a in case[1:]]
    want = np.array(jax_transition(*args, row_block=4, interpret=True)
                      .astype(jnp.float32))
    err, share = bf16_agree(got, torch.as_tensor(want))
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


# --- ipa_attention ---------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 11, 3, 8, 2, 4, 16),
                                   (1, 13, 4, 16, 4, 8, 32)])
def test_ipa_attention_plain_matches_jax(shape):
    args = _ipa_case(4, *shape)
    got = [o.numpy() for o in ipa_op.ipa_attention_plain(
        *[t(a) for a in args])]
    jargs = [jnp.asarray(a) for a in args]
    for want in (ipa_attention_reference(*jargs),
                 jax_ipa(*jargs, row_block=8, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_ipa_cancel_case_plain_matches_jax_in_bf16():
    """The scalar attend's rounding of p: on the cancellation case the
    port's plain version in bf16 and the JAX reference in bf16 (both take
    p in the input dtype) agree within the output's bf16 rounding, while
    the tolerance tells them from an f32-p attend
    (tests/test_torch_kernels.py)."""
    import torch
    case = _ipa_cancel_case()
    got = ipa_op.ipa_attention_plain(*_ipa_cancel_inputs(case,
                                                         torch.bfloat16))[0]
    jargs = [jnp.asarray(a, jnp.bfloat16) if i in (0, 1, 2, 9)
             else jnp.asarray(a) for i, a in enumerate(case)]
    want = np.asarray(ipa_attention_reference(*jargs)[0].astype(jnp.float32))
    assert _cancel_err(got, torch.as_tensor(want)) <= IPA_CANCEL_TOL / 2


# --- tri_mult_pre / tri_mult_post ------------------------------------------
# Small shapes: odd L, a partial mask, nc below and above one 64-channel
# chunk of the kernel's packed layout.

TRI_MULT_CPU_SHAPES = [(2, 9, 16, 8), (1, 11, 24, 72)]


@pytest.mark.parametrize('shape', TRI_MULT_CPU_SHAPES)
def test_tri_mult_pre_plain_matches_jax(shape):
    args = _tri_mult_pre_case(13, *shape)
    got = [o.numpy() for o in _tri_mult_pre_port(args)]
    jargs = [jnp.asarray(a) for a in args]
    for want in (tri_mult_pre_reference(*jargs),
                 jax_tri_mult_pre(*jargs, row_block=4, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize('shape', TRI_MULT_CPU_SHAPES)
def test_tri_mult_post_plain_matches_jax(shape):
    b, l, c, nc = shape
    args = _tri_mult_post_case(14, b, l, nc, c)
    got = _tri_mult_post_port(args).numpy()
    jargs = [jnp.asarray(a) for a in args]
    for want in (tri_mult_post_reference(*jargs),
                 jax_tri_mult_post(*jargs, row_block=4, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


# --- tri_mult_pre / tri_mult_post in bf16 ----------------------------------
# The bf16 check above, for the repaired plain versions: each product of
# values in the input dtype summed in f32 (preferred_element_type=f32), not
# rounded to bf16 before its bias; LN(x) rounded to the input dtype, one
# rounding of each output.  Rounding the product first made 16-29% of
# these outputs differ from the Pallas kernel's.

def _bf16_inputs(args, low):
    """The case as port tensors and JAX arrays, those at `low` in bf16 (the
    rest f32, integer arrays as they are)."""
    import torch
    port = [torch.as_tensor(a) if a.dtype.kind != 'f'
            else t(a).bfloat16() if i in low else t(a)
            for i, a in enumerate(args)]
    jax_args = [jnp.asarray(a, jnp.bfloat16) if i in low else jnp.asarray(a)
                for i, a in enumerate(args)]
    return port, jax_args


def _assert_bf16_agree(got, want):
    import torch
    err, share = bf16_agree(got, torch.as_tensor(np.array(
        want.astype(jnp.float32))))
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


@pytest.mark.parametrize('kind', ['pre', 'post', 'post_c_major'])
@pytest.mark.parametrize('shape', TRI_MULT_CPU_SHAPES)
def test_tri_mult_plain_matches_pallas_interpret_in_bf16(kind, shape):
    """post_c_major: y channel-major (B, nc, L, L) into both, the Pallas
    kernel's transpose in VMEM against the plain version's permute."""
    b, l, c, nc = shape
    if kind == 'pre':
        args = _tri_mult_pre_case(24, *shape)
        (x, s, lb, w, wb, mask), jargs = _bf16_inputs(args, {0})
        got = tri_mult_op.tri_mult_pre_plain(x, s, lb, w.T, wb, mask)
        want = jax_tri_mult_pre(*jargs, row_block=4, interpret=True)
    else:
        c_major = kind == 'post_c_major'
        args = list(_tri_mult_post_case(25, b, l, nc, c))
        if c_major:
            args[0] = np.ascontiguousarray(args[0].transpose(0, 3, 1, 2))
        (y, s, lb, w, wb, fg, res), jargs = _bf16_inputs(args, {0, 5, 6})
        got = (tri_mult_op.tri_mult_post_plain(y, s, lb, w.T, wb, fg, res,
                                               y_c_major=c_major),)
        want = (jax_tri_mult_post(*jargs, row_block=4, y_c_major=c_major,
                                  interpret=True),)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        _assert_bf16_agree(g, w_)


# --- recycle_embed ---------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 9, 16, 24, 7), (1, 11, 20, 36, 15)])
def test_recycle_embed_plain_matches_jax(shape):
    args = _recycle_case(15, *shape)
    got = _recycle_port(args).numpy()
    jargs = [jnp.asarray(a) for a in args[:-1]] + [
        jnp.asarray(args[-1], jnp.int32)]
    for want in (recycle_embed_reference(*jargs),
                 jax_recycle(*jargs, row_block=4, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize('shape', [(2, 9, 16, 24, 7), (1, 8, 128, 192, 15)])
def test_recycle_embed_plain_matches_pallas_interpret_in_bf16(shape):
    """Every term in f32, one rounding of the output: the plain version in
    bf16 against the Pallas kernel in interpret mode in bf16; three bins
    out of range, which add zero (the kernel's one-hot product)."""
    args = _recycle_case(26, *shape)
    args[-1][0, 0, :3] = [-1, shape[-1], shape[-1] + 2]
    port, jargs = _bf16_inputs(args, {0, 2})
    jargs[-1] = jnp.asarray(args[-1], jnp.int32)
    got = recycle_op.recycle_embed_plain(*port)
    _assert_bf16_agree(got, jax_recycle(*jargs, row_block=4,
                                        interpret=True))
