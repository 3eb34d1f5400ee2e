"""The flash route's attention (`ops/esm_attention.py::
esm_flash_attention_plain`) against the JAX package's
`_esm_flash_attention` (JAX's stock Pallas TPU flash kernel, run in
interpret mode) on every row, the padded query rows included.  f32 within
1e-5 of max|ref|; bf16 within 3e-2 of max|ref| with at most 1% of the
outputs more than one bf16 step apart.

A file of its own, with few tests: pytest-xdist's `--dist loadfile` hands
out the files with the most tests first, and this keeps
tests/test_torch_esm.py (its ESM-on design runs) behind the suite's
longest file in that queue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from abx_tpu.models import esm as jax_esm
from abx_tpu_torch.ops import esm_attention as esm_op

REL = 1e-5          # f32, relative to max|ref|


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('l', [40, 150])
def test_esm_flash_attention_plain_matches_jax_flash_kernel(l, dtype):
    """`esm_flash_attention_plain` against `_esm_flash_attention` (the
    stock Pallas TPU flash kernel in interpret mode) on every row, the
    padded query rows included (they attend to the padded keys and the
    zero tail only): L = 40 (one 128-key block, the stock kernel's one-step
    path) and L = 150 (two blocks, the running max), D = 64, a padded tail
    and one key padded in the middle of a row.  f32 within 1e-5 of
    max|ref|; bf16 within 3e-2, at most 1% of the outputs more than one
    bf16 step apart.  The valid rows equal esm_attention's."""
    b, h, d = 2, 3, 64
    rng = np.random.default_rng(l)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32)
               for _ in range(3))
    q *= np.float32(3 * d ** -0.5)
    pad = np.zeros((b, l), bool)
    pad[:, -7:] = True
    pad[1, l // 3] = True
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_esm._esm_flash_attention(
            *(jnp.asarray(x, jdt) for x in (q, k, v)),
            jnp.asarray(pad)).astype(jnp.float32))
    qkv = [torch.tensor(x).to(tdt) for x in (q, k, v)]
    got = esm_op.esm_flash_attention_plain(
        *qkv, torch.tensor(pad)).float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    # One bf16 step of want: 2^(e - 8) for |want| = m 2^e, m in [0.5, 1).
    share = (err > np.ldexp(np.float32(1), np.frexp(want)[1] - 8)).mean()
    print(f'L={l} {dtype}: max err / max|ref| {err.max() / scale:.3g}, '
          f'share past one bf16 step {share:.3g}')
    if dtype == 'bfloat16':
        assert err.max() <= 3e-2 * scale, (err.max(), scale)
        assert share <= 1e-2, share
        return
    assert err.max() <= REL * scale, (err.max(), scale)
    valid = np.broadcast_to(~pad[:, None, :, None], got.shape)
    plain = esm_op.esm_attention_plain(*qkv, torch.tensor(pad)).numpy()
    np.testing.assert_allclose(got[valid], plain[valid], rtol=0,
                               atol=REL * scale)
    assert np.abs(got - plain)[~valid].max() > 1e-3   # another function
