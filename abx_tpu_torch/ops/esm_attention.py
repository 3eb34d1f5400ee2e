"""ESM2 self-attention with a key padding mask, and its flash route.

`esm_attention` is the counterpart of abx_tpu/ops/esm_attention.py::
esm_attention (the Pallas TPU kernel): per (batch, head), softmax(q k^T +
pad bias) v with f32 logits and an f32 softmax, the probabilities cast to
the input dtype before the PV product.  `esm_flash_attention` is the
counterpart of abx_tpu/models/esm.py::_esm_flash_attention (JAX's stock
Pallas TPU flash kernel with segment ids, the `ABX_FLASH_ESM` route): a
query attends to the keys of its own segment (valid or padded), L padded
with zeros to a multiple of 128 in the padded segment, the softmax taken
online a 128-key block with P rounded to v's dtype against the running
max.  On the card `esm_attention` launches `csrc/esm_attention.cu` and
`esm_flash_attention` the entry of `csrc/esm_flash_sm90.cu`: in bf16 the
Hopper kernel there (TMA and wgmma, one 128-key block a warpgroup
product), in f32 the register-resident flash core of
`csrc/flash_attention.cuh` in its segment mode, the core `esm_attention`
runs too.  Both read q / k / v through strides (head-major views of the
(B, L, H, D) projection output need no copy), read the bool padding mask
themselves and write the output in (B, L, H, D) memory order; the (B, H,
L, L) logits never reach device memory.  See the source notes for what
bounds them.
"""

from __future__ import annotations

import ctypes

import torch

from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9
MAX_HEAD_DIM = 128   # the kernel's largest compile-time head dim
# The flash route: the stock kernel's key block and mask value; its kernel
# takes D up to 64 in f32 (shared memory), 128 in bf16.
FLASH_BLOCK = 128
FLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_MAX_HEAD_DIM = {torch.float32: 64, torch.bfloat16: 128}


def esm_attention_plain(q, k, v, padding_mask):
    """Plain PyTorch version (the JAX `esm_attention_reference`): f32
    logits, additive BIG_NEG key mask, f32 softmax, probabilities in
    q.dtype for the PV product; returns q.dtype."""
    logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float())
    neg = padding_mask.float() * BIG_NEG
    probs = torch.softmax(logits + neg[:, None, None, :], dim=-1)
    return torch.einsum('bhqk,bhkd->bhqd', probs.to(q.dtype),
                        v).to(q.dtype)


def esm_flash_attention_plain(q, k, v, padding_mask):
    """Plain PyTorch version of the stock TPU flash kernel as
    `_esm_flash_attention` calls it: q, k, v zero-padded to Lp, a multiple
    of 128; segment ids 1 - pad, the padded tail in segment 0; sm_scale 1;
    per 128-key block, f32 logits plus FLASH_MASK_VALUE where the segments
    differ, the running max m, p = exp(s - m) rounded to v's dtype for the
    PV product and the f32 accumulator renormalised by l_corr / l_next;
    cropped back to L.  Where Lp is one block (L <= 128) the stock kernel
    takes its one-step path instead: p = exp(s - m) / l, normalised before
    it is rounded.  Every row is meaningful: a padded query's is the
    softmax over the padded keys and the zero tail."""
    b, h, l, d = q.shape
    lp = -(-l // FLASH_BLOCK) * FLASH_BLOCK
    qp, kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, lp - l))
                  for x in (q, k, v))
    seg = torch.nn.functional.pad(
        (padding_mask == 0).to(torch.int32), (0, lp - l))
    bias = torch.where(seg[:, :, None] == seg[:, None, :], 0.0,
                       FLASH_MASK_VALUE)[:, None]
    qf = qp.float()
    if lp == FLASH_BLOCK:
        s = torch.einsum('bhqd,bhkd->bhqk', qf, kp.float()) + bias
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        out = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(),
                           vp.float())
        return out[:, :, :l].to(q.dtype)
    m = torch.full((b, h, lp, 1), -torch.inf, device=q.device)
    lsum = torch.zeros((b, h, lp, 1), device=q.device)
    acc = torch.zeros((b, h, lp, d), device=q.device)
    for k0 in range(0, lp, FLASH_BLOCK):
        blk = slice(k0, k0 + FLASH_BLOCK)
        s = torch.einsum('bhqd,bhkd->bhqk', qf, kp[:, :, blk].float())
        s = s + bias[..., blk]
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * lsum
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        o = torch.einsum('bhqk,bhkd->bhqd', p.to(v.dtype).float(),
                         vp[:, :, blk].float())
        acc = acc + o * inv
        m, lsum = m_next, l_next
    return acc[:, :, :l].to(q.dtype)


def _takes(q, k, v, padding_mask, max_head_dim=None) -> bool:
    """The kernel takes these operands: CUDA tensors of one supported dtype
    and shape, D a multiple of 8 up to MAX_HEAD_DIM (`max_head_dim` of the
    dtype where given), unit stride along D, 16-byte aligned rows.  Cheap:
    it runs on every call."""
    dt, shape = q.dtype, q.shape
    d = shape[3]
    top = MAX_HEAD_DIM if max_head_dim is None else max_head_dim.get(dt, 0)
    if (dt not in _lib.DTYPE_CODE or d % 8 or d > top
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


def _reject(q, k, v, padding_mask, name='esm_attention',
            head_dims=f'up to {MAX_HEAD_DIM}'):
    """Raise ValueError naming what the kernel takes and what it got."""
    got = '; '.join(
        f'{arg} {x.dtype} {tuple(x.shape)} strides {x.stride()} on '
        f'{x.device}' for arg, x in (('q', q), ('k', k), ('v', v),
                                     ('padding_mask', padding_mask)))
    raise ValueError(
        f'{name}: the kernel takes CUDA q, k, v of one dtype in '
        f'{list(_lib.DTYPE_CODE)}, (B, H, L, D) with D a multiple of 8 '
        f'{head_dims}, unit stride along D and 16-byte aligned rows, and a '
        f'CUDA (B, L) padding_mask; got {got}')


def _launch(fn, name, q, k, v, padding_mask):
    """One launch of `fn` (abx_esm_attention or abx_esm_flash_attention,
    for the wrapper `name`) on operands `_takes` accepted; returns the
    (B, H, L, D) view of a (B, L, H, D) output."""
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
    _lib.check(fn(
        _lib.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pad.data_ptr(), out.data_ptr(), ctypes.addressof(strides), b, l, h,
        d, _lib.stream(q)), name)
    return out


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
    out = _launch(_lib.lib().abx_esm_attention, 'esm_attention', q, k, v,
                  padding_mask)
    esm_attention.launches += 1
    return out


esm_attention.launches = 0


def esm_flash_attention(q, k, v, padding_mask):
    """The flash route's attention (`ABX_FLASH_ESM`), the function of
    `esm_flash_attention_plain`.

    Args as `esm_attention`'s; D a multiple of 8 up to
    FLASH_MAX_HEAD_DIM[dtype].  Returns (B, H, L, D) in q.dtype, on the
    card a view of a (B, L, H, D) tensor.  Every row is the stock kernel's,
    the padded ones included.  On a CPU tensor it is the plain version; on
    the card it launches the kernel or raises.
    """
    if not registry.on_device(q):
        return esm_flash_attention_plain(q, k, v, padding_mask)
    _lib.refuse_autograd('esm_flash_attention', q, k, v)
    if not _takes(q, k, v, padding_mask, FLASH_MAX_HEAD_DIM):
        _reject(q, k, v, padding_mask, 'esm_flash_attention',
                'up to 64 in float32 and 128 in bfloat16')
    out = _launch(_lib.lib().abx_esm_flash_attention,
                  'esm_flash_attention', q, k, v, padding_mask)
    esm_flash_attention.launches += 1
    return out


esm_flash_attention.launches = 0


def flash_kernel_info(head_dim: int, length: int) -> dict:
    """What the bf16 flash route's Hopper kernel gets on this card for
    head dim `head_dim` at length `length`: CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    (spill) bytes a thread, dynamic shared memory bytes a CTA."""
    info = (ctypes.c_int * 4)()
    _lib.check(_lib.lib().abx_esm_flash_sm90_info(
        head_dim, length, ctypes.addressof(info)), 'flash_kernel_info')
    return dict(zip(('ctas_per_sm', 'registers', 'local_bytes',
                     'smem_bytes'), info))
