"""Fused triangle-multiplication pre and post blocks.

Counterparts of abx_tpu/ops/tri_mult.py::tri_mult_pre and ::tri_mult_post
(Pallas TPU kernels), in their default form (natural layout, the final gate
emitted by pre); the contraction between them stays a plain batched GEMM
(`ops/triangle.py`).  On the card both run `csrc/row_linear.cu`: pre as
its gated-pairs mode (entry `abx_tri_mult_pre`), post as the plain row
linear with a sigmoid gate and the residual in its epilogue.  The
LayerNorm is applied while a tile is staged, so the normalised tensor never
reaches device memory; see the source note there for what bounds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry

_HALF = 64   # value channels per packed N tile (csrc/row_linear.cu kHalf)


def tri_mult_pre_plain(x, scale, bias, w, wb, mask, eps: float = 1e-5):
    """Plain PyTorch version (mirrors tri_mult_pre_reference): LN in f32,
    the product in the input dtype, bias / gating / mask in f32."""
    c = x.shape[-1]
    nc = (w.shape[0] - c) // 4
    dt = x.dtype
    ln = layer_norm(x, scale, bias, eps, dtype=dt)
    y = F.linear(ln, w.to(dt)).float() + wb.float()
    pm = (mask[:, :, None] * mask[:, None, :]).float()[..., None]
    left = y[..., :nc] * torch.sigmoid(y[..., 2 * nc:3 * nc]) * pm
    right = y[..., nc:2 * nc] * torch.sigmoid(y[..., 3 * nc:4 * nc]) * pm
    return left.to(dt), right.to(dt), y[..., 4 * nc:].to(dt)


def _pack(value, gate):
    """[64 value rows | their 64 gate rows] per 64-channel chunk, the last
    chunk padded with zero rows: the N-tile layout of the gated mode."""
    nc = value.shape[0]
    pad = -nc % _HALF

    def chunks(a):
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        return a.reshape((-1, _HALF) + a.shape[1:])
    return torch.stack([chunks(value), chunks(gate)], dim=1).reshape(
        (-1,) + value.shape[1:])


def tri_mult_pre(x, scale, bias, w, wb, mask):
    """LN -> fused [left|right|left gate|right gate|final gate] projection
    -> left * sigmoid(left gate) * pair mask, likewise right.

    Args:
        x: (B, L, L, C) pair activations.
        scale, bias: (C,) LayerNorm params.
        w: (4*nc + C, C), wb: (4*nc + C,): the five projections stacked
            in that order (nn.Linear layout).
        mask: (B, L) sequence mask; the pair mask is mask_i * mask_j.
    Returns: left, right (B, L, L, nc) and the pre-sigmoid final gate
        (B, L, L, C), all in x.dtype.
    """
    if not registry.on_device(x):
        return tri_mult_pre_plain(x, scale, bias, w, wb, mask)
    b, r, l, c = x.shape
    nc = (w.shape[0] - c) // 4
    dt = x.dtype
    _lib.require(r == l and w.shape == (4 * nc + c, c)
                 and wb.shape == (4 * nc + c,) and mask.shape == (b, l),
                 'tri_mult_pre: x (B, L, L, C), w (4*nc + C, C), wb, '
                 'mask (B, L)')
    wf, bf = w.float(), wb.float()
    w_parts = torch.split(wf, [nc, nc, nc, nc, c])
    b_parts = torch.split(bf, [nc, nc, nc, nc, c])
    w_packed = torch.cat([_pack(w_parts[0], w_parts[2]),
                          _pack(w_parts[1], w_parts[3]),
                          w_parts[4]]).to(dt).contiguous()
    b_packed = torch.cat([_pack(b_parts[0], b_parts[2]),
                          _pack(b_parts[1], b_parts[3]),
                          b_parts[4]]).contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    maskf = mask.float().contiguous()
    _lib.check_cuda_inputs('tri_mult_pre', dt, x=x, w=w_packed,
                           f32=dict(wb=b_packed, scale=scale, bias=bias,
                                    mask=maskf))
    _lib.require(scale.shape == (c,) and bias.shape == (c,),
                 'tri_mult_pre: LN params must be (C,)')
    lr = torch.empty((2, b, r, l, nc), dtype=dt, device=x.device)
    fg = torch.empty((b, r, l, c), dtype=dt, device=x.device)
    err = _lib.lib().abx_tri_mult_pre(
        _lib.DTYPE_CODE[dt], x.data_ptr(), b * r * l, c, scale.data_ptr(),
        bias.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(),
        w_packed.shape[0], maskf.data_ptr(), r, l, nc, lr.data_ptr(),
        fg.data_ptr(), _lib.stream(x))
    _lib.check(err, 'tri_mult_pre')
    tri_mult_pre.launches += 1
    return lr[0], lr[1], fg


tri_mult_pre.launches = 0


def tri_mult_post_plain(y, scale, bias, w, wb, fg, res, eps: float = 1e-5):
    """Plain PyTorch version (mirrors tri_mult_post_reference)."""
    dt = y.dtype
    ln = layer_norm(y, scale, bias, eps, dtype=dt)
    o = F.linear(ln, w.to(dt)).float() + wb.float()
    o = o * torch.sigmoid(fg.float())
    return (o + res.float()).to(res.dtype)


def tri_mult_post(y, scale, bias, w, wb, fg, res):
    """LN -> Linear(nc, C) -> * sigmoid(fg) -> + res.

    Args:
        y: (B, L, L, nc) triangle contraction output.
        scale, bias: (nc,) LayerNorm params.
        w: (C, nc), wb: (C,) (nn.Linear layout).
        fg: (B, L, L, C) pre-sigmoid final gate; res: (B, L, L, C).
    Returns: (B, L, L, C) in y.dtype.
    """
    if not registry.on_device(y):
        return tri_mult_post_plain(y, scale, bias, w, wb, fg, res)
    b, r, l, nc = y.shape
    c = w.shape[0]
    dt = y.dtype
    y = y.contiguous()
    w = w.to(dt).contiguous()
    wb = wb.float().contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _lib.check_cuda_inputs('tri_mult_post', dt, y=y, w=w, fg=fg, res=res,
                           f32=dict(wb=wb, scale=scale, bias=bias))
    _lib.require(w.shape == (c, nc) and wb.shape == (c,)
                 and scale.shape == (nc,) and bias.shape == (nc,)
                 and fg.shape == (b, r, l, c) and res.shape == (b, r, l, c),
                 'tri_mult_post: w (C, nc), wb (C,), LN params (nc,), '
                 'fg and res (B, L, L, C)')
    out = torch.empty_like(res)
    err = _lib.lib().abx_row_linear(
        _lib.DTYPE_CODE[dt], y.data_ptr(), b * r * l, nc, nc,
        scale.data_ptr(), bias.data_ptr(), w.data_ptr(), wb.data_ptr(),
        res.data_ptr(), fg.data_ptr(), out.data_ptr(), c, 0, 1, 1,
        _lib.stream(y))
    _lib.check(err, 'tri_mult_post')
    tri_mult_post.launches += 1
    return out


tri_mult_post.launches = 0
