"""The channel-major triangle multiplication, the head-major and the
column triangle attentions, and the bf16 softmax exponent against the JAX
package.

Plain versions (what the wrappers run on a CPU tensor) against the Pallas
kernels in interpret mode and the JAX `*_reference` functions, in f32 at
tiny shapes, to 1e-4 * max|ref|:
- `tri_mult_pre(c_major=True)`, `triangle_multiply_c_major` in both
  orientations and `tri_mult_post(y_c_major=True)`, at b=1, L=14, C=24,
  nc=8 with 2 masked positions (and the Pallas kernels' row block of 4
  leaving a partial block);
- `triangle_attention_fused` (row block 4 over 6 rows: a ragged block);
- `triangle_attention_packed_cols` (column block 4, 3 keys masked).
The bf16-exponent softmax of the plain versions is held to the JAX
kernels' expression `jnp.exp((logits - m).astype(bf16)).astype(f32)`,
normalised, to 1e-6.  The whole network on the channel-major route is in
tests/test_torch_modules.py (`test_c_major_forward_with_recycling_
matches_jax`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.ops.tri_attention import triangle_attention_fused as jax_fused
from abx_tpu.ops.tri_attention import \
    triangle_attention_packed_cols as jax_cols
from abx_tpu.ops.tri_attention import (
    triangle_attention_packed_cols_reference, triangle_attention_reference)
from abx_tpu.ops.tri_mult import tri_mult_post as jax_tri_mult_post
from abx_tpu.ops.tri_mult import tri_mult_pre as jax_tri_mult_pre
from abx_tpu.ops.triangle import \
    triangle_multiply_c_major as jax_contract_c_major
from abx_tpu_torch.ops import tri_attention as ta_op
from abx_tpu_torch.ops import tri_mult as tm_op
from abx_tpu_torch.ops import triangle as triangle_op
from tests.test_torch_kernels import (_cols_case, _cols_port, _fused_case,
                                      _tri_mult_post_case, _tri_mult_pre_case,
                                      t)

REL_TOL = 1e-4   # max|plain - JAX| <= REL_TOL * max|JAX|, f32


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


C_MAJOR_SHAPE = (1, 14, 24, 8)   # (b, l, c, nc), as tests/test_ops.py


@pytest.fixture(scope='module')
def c_major_pre():
    """One tri_mult_pre case, the JAX kernel's c_major outputs and the
    port's plain ones."""
    x, s, lb, w, wb, mask = _tri_mult_pre_case(40, *C_MAJOR_SHAPE)
    want = jax_tri_mult_pre(*(jnp.asarray(a) for a in (x, s, lb, w, wb,
                                                       mask)),
                            row_block=4, c_major=True, interpret=True)
    got = tm_op.tri_mult_pre(t(x), t(s), t(lb), t(w.T), t(wb), t(mask),
                             c_major=True)
    return x, want, got


def test_tri_mult_pre_c_major_plain_matches_jax(c_major_pre):
    _, want, got = c_major_pre
    b, l, c, nc = C_MAJOR_SHAPE
    assert got[0].shape == (b, nc, l, l) and got[2].shape == (b, l, l, c)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize('per_row', [True, False])
def test_c_major_contraction_and_post_match_jax(c_major_pre, per_row):
    """The contraction on the c-major operands, then post reading it
    channel-major, against the JAX functions on the same inputs."""
    x, (jl, jr, jfg), _ = c_major_pre
    b, l, c, nc = C_MAJOR_SHAPE
    left, right, fg = (t(np.array(a)) for a in (jl, jr, jfg))
    y = triangle_op.triangle_multiply_c_major(left, right, per_row)
    want_y = jax_contract_c_major(jl, jr, per_row=per_row)
    _close(y.numpy(), want_y)
    _, s, lb, w, wb, _, _ = _tri_mult_post_case(41, b, l, nc, c)
    got = tm_op.tri_mult_post(y, t(s), t(lb), t(w.T), t(wb), fg, t(x),
                              y_c_major=True)
    want = jax_tri_mult_post(want_y, jnp.asarray(s), jnp.asarray(lb),
                             jnp.asarray(w), jnp.asarray(wb), jfg,
                             jnp.asarray(x), row_block=4, y_c_major=True,
                             interpret=True)
    _close(got.numpy(), want)


def test_triangle_attention_fused_plain_matches_jax():
    """6 rows against a row block of 4, odd L, D = 8."""
    q, k, v, bias, mask = _fused_case(42, 2, 6, 2, 11, 8)
    got = ta_op.triangle_attention_fused(t(q), t(k), t(v), t(bias),
                                         t(mask)).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, bias, mask)]
    _close(got, triangle_attention_reference(*args))
    _close(got, jax_fused(*args, row_block=4, interpret=True))


def test_triangle_attention_packed_cols_plain_matches_jax():
    """b=2, L=16, C=8, H=2 (D=4), the last 3 keys masked."""
    case = _cols_case(43, 2, 16, 8, 2)
    got = _cols_port(case, ta_op.triangle_attention_packed_cols).numpy()
    args = [jnp.asarray(a) for a in case]
    _close(got, triangle_attention_packed_cols_reference(*args))
    _close(got, jax_cols(*args, col_block=4, interpret=True))


def test_softmax_bf16_exp_matches_the_jax_expression():
    """Logits with a masked key (BIG_NEG) and a wide range, so that the
    rounding of the shifted logits and of their exponent both show."""
    rng = np.random.default_rng(44)
    logits = (8.0 * rng.standard_normal((3, 5, 97))).astype(np.float32)
    logits[:, :, -1] = -1e9
    m = jnp.max(logits, axis=-1, keepdims=True)
    e = jnp.exp((logits - m).astype(jnp.bfloat16)).astype(jnp.float32)
    want = np.asarray(e / jnp.sum(e, axis=-1, keepdims=True))
    got = ta_op.softmax_bf16_exp(t(logits)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # ... and it is not the f32 softmax.
    f32 = torch.softmax(t(logits), -1).numpy()
    assert np.abs(got - f32).max() > 1e-4
