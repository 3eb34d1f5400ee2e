"""Fused pair-bias projection: LayerNorm(pair) -> C->H, in (B, H, R, L).

Counterpart of abx_tpu/ops/pair_bias.py::pair_bias_proj (the Pallas TPU
kernel), always in its `transpose_out=True` form, which is the only one the
model uses.  On the card, bf16 launches with C <= 192 (a multiple of 8)
and H <= 64 run the Hopper kernel of `csrc/pair_bias.cu`; the others (f32,
other shapes) the tile kernel of `csrc/row_linear.cu` (out_mode 1).  Both
read the pair track once, normalise it on the way and write the bias
straight into the attention-bias layout.  See the source notes there for
what bounds them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


class PairBiasPack(NamedTuple):
    """pair_bias_proj's weights as the kernels take them: the (H, C)
    projection in the compute dtype and the f32 LayerNorm params."""
    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def pack_pair_bias(scale, bias, w, dtype) -> PairBiasPack:
    return PairBiasPack(w.to(dtype).contiguous(), scale.float().contiguous(),
                        bias.float().contiguous())


def hopper_route(pair, h: int) -> bool:
    """True when a launch takes the Hopper kernel (csrc/pair_bias.cu):
    bf16, C <= 192 a multiple of 8, H <= 64, 16-byte aligned rows; the tile
    kernel takes the rest.  Decided before the launch."""
    c = pair.shape[-1]
    return (pair.dtype == torch.bfloat16 and c % 8 == 0 and c <= 192
            and h <= 64 and pair.data_ptr() % 16 == 0)


def pair_bias_proj_plain(pair, scale, bias, w, eps: float = 1e-5,
                         packed=None):
    """Plain PyTorch version, at the TPU kernel's rounding points: LN in
    f32, rounded to the input dtype, the (H, C) projection of values in the
    input dtype summed in f32 and rounded once; returns (B, H, R, L) in
    pair.dtype.  `packed` (the kernels' weights) is not used."""
    dt = pair.dtype
    ln = layer_norm(pair, scale, bias, eps, dtype=dt)
    y = F.linear(ln.float(), w.to(dt).float()).to(dt)
    return y.permute(0, 3, 1, 2).contiguous()


def pair_bias_proj(pair, scale, bias, w, packed: PairBiasPack | None = None):
    """LayerNorm(pair) @ w^T in one pass.

    Args:
        pair: (B, R, L, C) pair activations.
        scale, bias: (C,) LayerNorm params.
        w: (H, C) head projection (nn.Linear layout, no bias).
        packed: the same weights as `pack_pair_bias` packs them for
            pair.dtype (a module caches it, so a call launches the kernel
            alone); packed here when None.
    Returns: (B, H, R, L) in pair.dtype — the attention-bias layout.
    """
    if not registry.on_device(pair):
        return pair_bias_proj_plain(pair, scale, bias, w)
    _lib.refuse_autograd('pair_bias_proj', pair, scale, bias, w)
    b, r, l, c = pair.shape
    h = w.shape[0]
    dt = pair.dtype
    if packed is None:
        packed = pack_pair_bias(scale, bias, w, dt)
    w, scale, bias = packed
    _lib.check_cuda_inputs('pair_bias_proj', dt, pair=pair, w=w,
                           f32=dict(scale=scale, bias=bias))
    _lib.require(w.shape == (h, c), 'pair_bias_proj: w must be (H, C)')
    _lib.require(scale.shape == (c,) and bias.shape == (c,),
                 'pair_bias_proj: LN params must be (C,)')
    out = torch.empty((b, h, r, l), dtype=dt, device=pair.device)
    if hopper_route(pair, h):
        err = _lib.lib().abx_pair_bias_proj(
            pair.data_ptr(), b * r * l, c, scale.data_ptr(), bias.data_ptr(),
            w.data_ptr(), h, r * l, out.data_ptr(), _lib.stream(pair))
    else:
        err = _lib.lib().abx_row_linear(
            _lib.DTYPE_CODE[dt], pair.data_ptr(), b * r * l, c, c,
            scale.data_ptr(), bias.data_ptr(), w.data_ptr(), None, None,
            None, out.data_ptr(), h, 1, r, l, _lib.stream(pair))
    _lib.check(err, 'pair_bias_proj')
    pair_bias_proj.launches += 1
    return out


pair_bias_proj.launches = 0
