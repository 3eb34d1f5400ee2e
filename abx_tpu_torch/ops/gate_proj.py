"""Fused attention epilogue: (sigmoid(gate) * y) @ w^T + wb + res.

Counterpart of abx_tpu/ops/gate_proj.py::gate_proj_residual (the Pallas
TPU kernel), taken by the triangle attentions without the LN-fold
(`ABX_TRI_ATTN_LN_FOLD=0`) when `ABX_GATE_PROJ_KERNEL=1`.  The gate
multiplies BEFORE the projection, the reverse of the tri_mult post block.
On the card this runs `csrc/row_linear.cu` (entry `abx_gate_proj`): the
gate is applied while a tile of y is staged in shared memory, so the gated
tensor never reaches device memory; the bias and the residual are added in
the epilogue.  See the source note there for what bounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from abx_tpu_torch.ops import _lib, registry


def gate_proj_residual_plain(y, gate_pre, w, wb, res):
    """Plain PyTorch version, at the Pallas kernel's rounding points: the
    gated input z = y * sigmoid(gate) in f32, rounded to y's dtype; the
    projection of values in that dtype summed in f32; bias and residual in
    f32, rounded once."""
    dt = y.dtype
    z = (y.float() * torch.sigmoid(gate_pre.float())).to(dt)
    o = F.linear(z.float(), w.to(dt).float()) + wb.float()
    return (o + res.float()).to(res.dtype)


def gate_proj_residual(y, gate_pre, w, wb, res):
    """(sigmoid(gate_pre) * y) @ w^T + wb + res in one pass.

    Args:
        y: (B, R, L, HD) attention output.
        gate_pre: (B, R, L, HD) pre-sigmoid gate activations.
        w: (C, HD), wb: (C,) (nn.Linear layout).  res: (B, R, L, C).
    Returns: (B, R, L, C) in res.dtype.
    """
    if not registry.on_device(y):
        return gate_proj_residual_plain(y, gate_pre, w, wb, res)
    _lib.refuse_autograd('gate_proj_residual', y, gate_pre, w, wb, res)
    b, r, l, hd = y.shape
    c = w.shape[0]
    dt = y.dtype
    y, gate_pre, res = y.contiguous(), gate_pre.contiguous(), res.contiguous()
    w = w.to(dt).contiguous()
    wb = wb.float().contiguous()
    _lib.check_cuda_inputs('gate_proj_residual', dt, y=y, gate=gate_pre,
                           w=w, res=res, f32=dict(wb=wb))
    _lib.require(gate_pre.shape == y.shape and w.shape == (c, hd)
                 and wb.shape == (c,) and res.shape == (b, r, l, c),
                 'gate_proj_residual: y and gate (B, R, L, HD), w (C, HD), '
                 'wb (C,), res (B, R, L, C)')
    out = torch.empty_like(res)
    err = _lib.lib().abx_gate_proj(
        _lib.DTYPE_CODE[dt], y.data_ptr(), gate_pre.data_ptr(), b * r * l, hd,
        w.data_ptr(), wb.data_ptr(), res.data_ptr(), out.data_ptr(), c,
        _lib.stream(y))
    _lib.check(err, 'gate_proj_residual')
    gate_proj_residual.launches += 1
    return out


gate_proj_residual.launches = 0
