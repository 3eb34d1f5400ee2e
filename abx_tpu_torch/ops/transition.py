"""Fused pair-track transition block: LN -> C->4C -> ReLU -> 4C->C -> +x.

Counterpart of abx_tpu/ops/transition.py::fused_transition (the Pallas TPU
kernel).  On the card, bf16 launches with C <= 192 (a multiple of 8) run
the Hopper kernel of `csrc/transition_sm90.cu`, which keeps the hidden
activations in registers; the others (f32, other C) the kernel of
`csrc/transition.cu`, which keeps them in shared memory.  See the source
notes there for what bounds them and how.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


class TransitionPack(NamedTuple):
    """fused_transition's weights as the kernels take them: w1 (N, C) and
    w2 (C, N) in the compute dtype, the biases and LayerNorm params in
    f32."""
    scale: torch.Tensor
    bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def pack_transition(scale, bias, w1, b1, w2, b2, dtype) -> TransitionPack:
    return TransitionPack(scale.float().contiguous(),
                          bias.float().contiguous(),
                          w1.to(dtype).contiguous(), b1.float().contiguous(),
                          w2.to(dtype).contiguous(), b2.float().contiguous())


def hopper_route(x, n: int) -> bool:
    """True when a launch takes the Hopper kernel (csrc/transition_sm90.cu):
    bf16, C <= 192 a multiple of 8, N a multiple of 8, 16-byte aligned
    rows; csrc/transition.cu takes the rest.  Decided before the launch."""
    c = x.shape[-1]
    return (x.dtype == torch.bfloat16 and c % 8 == 0 and c <= 192
            and n % 8 == 0 and x.data_ptr() % 16 == 0)


def fused_transition_plain(x, scale, bias, w1, b1, w2, b2,
                           eps: float = 1e-5, packed=None):
    """Plain PyTorch version, at the TPU kernel's rounding points: LN in
    f32, rounded to the input dtype; the products of values in the input
    dtype summed in f32 (as preferred_element_type=f32), + b1 and ReLU in
    f32, rounded to the input dtype; + b2 + x in f32, rounded once.
    `packed` (the kernels' weights) is not used."""
    dt = x.dtype
    x32 = x.float()
    ln = layer_norm(x32, scale, bias, eps)
    h = torch.relu(F.linear(ln.to(dt).float(), w1.to(dt).float()) + b1)
    y = F.linear(h.to(dt).float(), w2.to(dt).float()) + b2
    return (y + x32).to(dt)


def fused_transition(x, scale, bias, w1, b1, w2, b2,
                     packed: TransitionPack | None = None):
    """x + Linear2(ReLU(Linear1(LN(x)))).

    Args:
        x: (..., C); scale, bias: (C,) LayerNorm params.
        w1: (N, C), b1: (N,), w2: (C, N), b2: (C,) (nn.Linear layouts).
        packed: the same weights as `pack_transition` packs them for
            x.dtype (a module caches it, so a call launches the kernel
            alone); packed here when None.
    Returns: x's shape and dtype.
    """
    if not registry.on_device(x):
        return fused_transition_plain(x, scale, bias, w1, b1, w2, b2)
    _lib.refuse_autograd('fused_transition', x, scale, bias, w1, b1, w2, b2)
    c = x.shape[-1]
    n = w1.shape[0]
    dt = x.dtype
    if packed is None:
        packed = pack_transition(scale, bias, w1, b1, w2, b2, dt)
    scale, bias, w1, b1, w2, b2 = packed
    _lib.check_cuda_inputs('fused_transition', dt, x=x, w1=w1, w2=w2,
                           f32=dict(scale=scale, bias=bias, b1=b1, b2=b2))
    _lib.require(w1.shape == (n, c) and w2.shape == (c, n),
                 'fused_transition: w1 must be (N, C) and w2 (C, N)')
    _lib.require(scale.shape == bias.shape == b2.shape == (c,)
                 and b1.shape == (n,), 'fused_transition: param shapes')
    _lib.require(c <= 256, 'fused_transition: at most 256 channels')
    out = torch.empty_like(x)
    m = x.numel() // c
    args = (x.data_ptr(), m, c, scale.data_ptr(), bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), n, _lib.stream(x))
    if hopper_route(x, n):
        err = _lib.lib().abx_fused_transition_sm90(*args)
    else:
        err = _lib.lib().abx_fused_transition(_lib.DTYPE_CODE[dt], *args)
    _lib.check(err, 'fused_transition')
    fused_transition.launches += 1
    return out


fused_transition.launches = 0
