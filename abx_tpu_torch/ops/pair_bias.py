"""Fused pair-bias projection: LayerNorm(pair) -> C->H, in (B, H, R, L).

Counterpart of abx_tpu/ops/pair_bias.py::pair_bias_proj (the Pallas TPU
kernel), always in its `transpose_out=True` form, which is the only one the
model uses.  On the card this runs `csrc/row_linear.cu` (out_mode 1): the
pair track is read once, the LayerNorm is applied while a tile is staged in
shared memory, and the bias is written straight into the attention-bias
layout.  See the source note there for what bounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


def pair_bias_proj_plain(pair, scale, bias, w, eps: float = 1e-5):
    """Plain PyTorch version: LN in f32, cast to the input dtype, then the
    (H, C) projection; returns (B, H, R, L) in pair.dtype."""
    dt = pair.dtype
    ln = layer_norm(pair, scale, bias, eps, dtype=dt)
    y = F.linear(ln, w.to(dt))
    return y.permute(0, 3, 1, 2).contiguous()


def pair_bias_proj(pair, scale, bias, w):
    """LayerNorm(pair) @ w^T in one pass.

    Args:
        pair: (B, R, L, C) pair activations.
        scale, bias: (C,) LayerNorm params.
        w: (H, C) head projection (nn.Linear layout, no bias).
    Returns: (B, H, R, L) in pair.dtype — the attention-bias layout.
    """
    if not registry.on_device(pair):
        return pair_bias_proj_plain(pair, scale, bias, w)
    b, r, l, c = pair.shape
    h = w.shape[0]
    dt = pair.dtype
    w = w.to(dt).contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _lib.check_cuda_inputs('pair_bias_proj', dt, pair=pair, w=w,
                           f32=dict(scale=scale, bias=bias))
    _lib.require(w.shape == (h, c), 'pair_bias_proj: w must be (H, C)')
    _lib.require(scale.shape == (c,) and bias.shape == (c,),
                 'pair_bias_proj: LN params must be (C,)')
    out = torch.empty((b, h, r, l), dtype=dt, device=pair.device)
    err = _lib.lib().abx_row_linear(
        _lib.DTYPE_CODE[dt], pair.data_ptr(), b * r * l, c, c,
        scale.data_ptr(), bias.data_ptr(), w.data_ptr(), None, None, None,
        out.data_ptr(), h, 1, r, l, _lib.stream(pair))
    _lib.check(err, 'pair_bias_proj')
    pair_bias_proj.launches += 1
    return out


pair_bias_proj.launches = 0
