"""Fused pair-track transition block: LN -> C->4C -> ReLU -> 4C->C -> +x.

Counterpart of abx_tpu/ops/transition.py::fused_transition (the Pallas TPU
kernel).  On the card this runs `csrc/transition.cu`, which keeps the 4C
intermediate in shared memory; see the source note there for what bounds
it and how.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


def fused_transition_plain(x, scale, bias, w1, b1, w2, b2,
                           eps: float = 1e-5):
    """Plain PyTorch version (mirrors fused_transition_reference): LN in
    f32, products in the input dtype, bias/ReLU/residual in f32."""
    dt = x.dtype
    x32 = x.float()
    ln = layer_norm(x32, scale, bias, eps)
    h = torch.relu(F.linear(ln.to(dt), w1.to(dt)).float() + b1)
    y = F.linear(h.to(dt), w2.to(dt)).float() + b2
    return (y + x32).to(dt)


def fused_transition(x, scale, bias, w1, b1, w2, b2):
    """x + Linear2(ReLU(Linear1(LN(x)))).

    Args:
        x: (..., C); scale, bias: (C,) LayerNorm params.
        w1: (N, C), b1: (N,), w2: (C, N), b2: (C,) (nn.Linear layouts).
    Returns: x's shape and dtype.
    """
    if not registry.on_device(x):
        return fused_transition_plain(x, scale, bias, w1, b1, w2, b2)
    c = x.shape[-1]
    n = w1.shape[0]
    dt = x.dtype
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    f32 = [t.float().contiguous() for t in (scale, bias, b1, b2)]
    _lib.check_cuda_inputs('fused_transition', dt, x=x, w1=w1, w2=w2,
                           f32=dict(scale=f32[0], bias=f32[1], b1=f32[2],
                                    b2=f32[3]))
    _lib.require(w1.shape == (n, c) and w2.shape == (c, n),
                 'fused_transition: w1 must be (N, C) and w2 (C, N)')
    _lib.require(f32[0].shape == f32[1].shape == f32[3].shape == (c,)
                 and f32[2].shape == (n,), 'fused_transition: param shapes')
    _lib.require(c <= 256, 'fused_transition: at most 256 channels')
    out = torch.empty_like(x)
    m = x.numel() // c
    err = _lib.lib().abx_fused_transition(
        _lib.DTYPE_CODE[dt], x.data_ptr(), m, c, f32[0].data_ptr(),
        f32[1].data_ptr(), w1.data_ptr(), f32[2].data_ptr(), w2.data_ptr(),
        f32[3].data_ptr(), out.data_ptr(), n, _lib.stream(x))
    _lib.check(err, 'fused_transition')
    fused_transition.launches += 1
    return out


fused_transition.launches = 0
