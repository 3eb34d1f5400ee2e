"""ESM2 self-attention with a key padding mask.

Counterpart of abx_tpu/ops/esm_attention.py::esm_attention (the Pallas TPU
kernel): per (batch, head), softmax(q k^T + pad bias) v with f32 logits and
an f32 softmax, the probabilities cast to the input dtype before the PV
product.  On the card the wrapper launches `csrc/esm_attention.cu`, which
reads q / k / v through strides (head-major views of the (B, L, H, D)
projection output need no copy) and writes the output in (B, L, H, D)
memory order; the (B, H, L, L) logits never reach device memory.  See the
source note there for what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9


def esm_attention_plain(q, k, v, padding_mask):
    """Plain PyTorch version (the JAX `esm_attention_reference`): f32
    logits, additive BIG_NEG key mask, f32 softmax, probabilities in
    q.dtype for the PV product; returns q.dtype."""
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float())
    neg = padding_mask.float() * BIG_NEG
    probs = torch.softmax(logits + neg[:, None, None, :], dim=-1)
    return torch.einsum('bhqk,bhkd->bhqd', probs.to(q.dtype),
                        v).to(q.dtype)


def esm_attention(q, k, v, padding_mask):
    """Fused per-head attention with a key padding mask.

    Args:
        q, k, v: (B, H, L, D), unit stride along D (any other strides); q
            pre-scaled by D**-0.5 and rotated.
        padding_mask: (B, L) bool / int, True / 1 = PAD token.
    Returns: (B, H, L, D) in q.dtype.  On the card it is a view of a
        (B, L, H, D) tensor, so `.transpose(1, 2)` gives it back
        contiguous.  Outputs at pad query rows are not meaningful.
    """
    if not registry.on_device(q):
        return esm_attention_plain(q, k, v, padding_mask)
    b, h, l, d = q.shape
    dt = q.dtype
    _lib.require(dt in _lib.DTYPE_CODE,
                 f'esm_attention: dtype {dt} not supported')
    for name, x in (('q', q), ('k', k), ('v', v)):
        _lib.require(x.is_cuda, f'esm_attention: {name} is not on a CUDA '
                     'device')
        _lib.require(x.dtype == dt and x.shape == (b, h, l, d),
                     f'esm_attention: {name} must be {dt} {(b, h, l, d)}, '
                     f'got {x.dtype} {tuple(x.shape)}')
        _lib.require(x.stride(-1) == 1,
                     f'esm_attention: {name} needs unit stride along D')
    _lib.require(padding_mask.shape == (b, l),
                 'esm_attention: padding_mask must be (B, L)')
    maskbias = (padding_mask.float() * BIG_NEG).contiguous()
    _lib.check_cuda_inputs('esm_attention', dt, f32=dict(maskbias=maskbias))
    out = torch.empty((b, l, h, d), dtype=dt, device=q.device).transpose(1, 2)
    # (batch, position, head) element strides of q, k, v and out.
    strides = (ctypes.c_longlong * 12)(*[
        s for x in (q, k, v, out) for s in (x.stride(0), x.stride(2),
                                            x.stride(1))])
    _lib.check(_lib.lib().abx_esm_attention(
        _lib.DTYPE_CODE[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        maskbias.data_ptr(), out.data_ptr(), ctypes.addressof(strides), b, l,
        h, d, _lib.stream(q)), 'esm_attention')
    esm_attention.launches += 1
    return out


esm_attention.launches = 0
