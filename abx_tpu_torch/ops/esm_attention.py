"""ESM2 self-attention with a key padding mask.

Counterpart of abx_tpu/ops/esm_attention.py::esm_attention (the Pallas TPU
kernel): per (batch, head), softmax(q k^T + pad bias) v with f32 logits and
an f32 softmax, the probabilities cast to the input dtype before the PV
product.  On the card the wrapper launches `csrc/esm_attention.cu` (the
register-resident flash core of `csrc/flash_attention.cuh`), which reads
q / k / v through strides (head-major views of the (B, L, H, D) projection
output need no copy), reads the bool padding mask itself and writes the
output in (B, L, H, D) memory order; the (B, H, L, L) logits never reach
device memory.  See the source note there for what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9
MAX_HEAD_DIM = 128   # the kernel's largest compile-time head dim


def esm_attention_plain(q, k, v, padding_mask):
    """Plain PyTorch version (the JAX `esm_attention_reference`): f32
    logits, additive BIG_NEG key mask, f32 softmax, probabilities in
    q.dtype for the PV product; returns q.dtype."""
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float())
    neg = padding_mask.float() * BIG_NEG
    probs = torch.softmax(logits + neg[:, None, None, :], dim=-1)
    return torch.einsum('bhqk,bhkd->bhqd', probs.to(q.dtype),
                        v).to(q.dtype)


def _takes(q, k, v, padding_mask) -> bool:
    """The kernel takes these operands: CUDA tensors of one supported dtype
    and shape, D a multiple of 8 up to MAX_HEAD_DIM, unit stride along D,
    16-byte aligned rows.  Cheap: it runs on every call."""
    dt, shape = q.dtype, q.shape
    d = shape[3]
    if (dt not in _lib.DTYPE_CODE or d % 8 or d > MAX_HEAD_DIM
            or not padding_mask.is_cuda
            or padding_mask.shape != (shape[0], shape[2])):
        return False
    align = 16 // q.element_size()
    for x in (q, k, v):
        st = x.stride()
        if (not x.is_cuda or x.dtype != dt or x.shape != shape or st[3] != 1
                or x.data_ptr() % 16 or (st[0] | st[1] | st[2]) % align):
            return False
    return True


def _reject(q, k, v, padding_mask):
    """Raise ValueError naming what the kernel takes and what it got."""
    got = '; '.join(
        f'{name} {x.dtype} {tuple(x.shape)} strides {x.stride()} on '
        f'{x.device}' for name, x in (('q', q), ('k', k), ('v', v),
                                     ('padding_mask', padding_mask)))
    raise ValueError(
        'esm_attention: the kernel takes CUDA q, k, v of one dtype in '
        f'{list(_lib.DTYPE_CODE)}, (B, H, L, D) with D a multiple of 8 up '
        f'to {MAX_HEAD_DIM}, unit stride along D and 16-byte aligned rows, '
        f'and a CUDA (B, L) padding_mask; got {got}')


def esm_attention(q, k, v, padding_mask):
    """Fused per-head attention with a key padding mask.

    Args:
        q, k, v: (B, H, L, D), unit stride along D (any other strides); q
            pre-scaled by D**-0.5 and rotated.
        padding_mask: (B, L) bool / int, True / 1 = PAD token (bool is
            read as it is; another dtype is compared with 0 first).
    Returns: (B, H, L, D) in q.dtype.  On the card it is a view of a
        (B, L, H, D) tensor, so `.transpose(1, 2)` gives it back
        contiguous.  Outputs at pad query rows are not meaningful.
    The checks on the card are one cheap predicate (`_takes`): the ESM2-3B
    pass calls this 36 times and is bound by the host.
    """
    if not registry.on_device(q):
        return esm_attention_plain(q, k, v, padding_mask)
    _lib.refuse_autograd('esm_attention', q, k, v)
    if not _takes(q, k, v, padding_mask):
        _reject(q, k, v, padding_mask)
    b, h, l, d = q.shape
    pad = padding_mask if padding_mask.dtype == torch.bool else (
        padding_mask != 0)
    if not pad.is_contiguous():
        pad = pad.contiguous()
    out = torch.empty((b, l, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    # (batch, position, head) element strides of q, k, v and out.
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    strides = (ctypes.c_longlong * 12)(
        qs[0], qs[2], qs[1], ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
        os_[0], os_[2], os_[1])
    _lib.check(_lib.lib().abx_esm_attention(
        _lib.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pad.data_ptr(), out.data_ptr(), ctypes.addressof(strides), b, l, h,
        d, _lib.stream(q)), 'esm_attention')
    esm_attention.launches += 1
    return out


esm_attention.launches = 0
