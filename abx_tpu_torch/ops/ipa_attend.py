"""IPA attend-over-pair: out[b, i, (h c)] = sum_j attn[b,h,i,j] pair[b,i,j,c].

Counterpart of abx_tpu/ops/ipa_attend.py::ipa_pair_attend (the Pallas TPU
kernel), taken by the IPA's non-fused route (`ABX_FUSED_IPA_ATTN=0`) when
`ABX_IPA_ATTEND=1`.  On the card this runs `csrc/ipa_attend.cu`: a block
takes a few query rows of one batch element (one wave of the SMs), streams
their pair rows through a TMA ring and contracts each with its (H x L)
attention rows on mma.sync, the heads as M; the f32 attention is rounded
to the pair dtype as its fragments are read.  See the source note there
for what bounds it.  One launch takes up to 16 heads and up to 192
channels (a multiple of 8); other shapes are cut into several launches
of the same kernel (`split_pair_attend`), so the wrapper takes every H
and C the Pallas kernel takes.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.ops import _lib, registry

MAX_HEADS = 16  # the M of one mma tile (csrc/ipa_attend.cu kHeads)
MAX_C = 192     # csrc/ipa_attend.cu kMaxC


def ipa_pair_attend_plain(attn, pair):
    """Plain PyTorch version, at the Pallas kernel's rounding points: attn
    rounded to the pair dtype, the products summed in f32, one rounding of
    the output."""
    dt = pair.dtype
    out = torch.einsum('bhij,bijc->bihc', attn.to(dt).float(), pair.float())
    b, l, h, c = out.shape
    return out.reshape(b, l, h * c).to(dt)


def split_pair_attend(attn, pair, launch):
    """out[b,i,(h c)] = sum_j attn[b,h,i,j] * pair[b,i,j,c] for any H and C,
    from launches of `launch(attn, pair)` (the same contraction) that each
    take at most MAX_HEADS heads and MAX_C channels, a multiple of 8.

    The heads are cut into the fewest equal groups of at most MAX_HEADS,
    the channels into the fewest chunks of at most MAX_C (equal, rounded
    up to a multiple of 8), the last chunk zero-padded to a multiple of 8
    (the pad channels give zero columns, which are dropped).  A shape
    within the limits is one call of `launch` on the tensors as given."""
    b, h, l, _ = attn.shape
    c = pair.shape[-1]
    if h <= MAX_HEADS and c <= MAX_C and c % 8 == 0:
        return launch(attn, pair)
    n_h = -(-h // MAX_HEADS)
    hg = -(-h // n_h)
    n_c = -(-c // MAX_C)
    cg = -(-c // n_c)
    cg = -(-cg // 8) * 8   # <= MAX_C, a multiple of 8
    # Each head group and channel chunk is copied once, for all launches.
    groups = [(h0, attn[:, h0:h0 + hg].contiguous())
              for h0 in range(0, h, hg)]
    out = pair.new_empty((b, l, h, c))
    for c0 in range(0, c, cg):
        cn = min(cg, c - c0)
        part = torch.nn.functional.pad(pair[..., c0:c0 + cn],
                                       (0, -cn % 8)).contiguous()
        for h0, a in groups:
            y = launch(a, part)
            out[:, :, h0:h0 + a.shape[1], c0:c0 + cn] = y.reshape(
                b, l, a.shape[1], -1)[..., :cn]
    return out.reshape(b, l, h * c)


def ipa_pair_attend(attn, pair):
    """out[b,i,(h c)] = sum_j attn[b,h,i,j] * pair[b,i,j,c].

    Args:
        attn: (B, H, L, L) attention probabilities (f32 on the kernel
            route).
        pair: (B, L, L, C) pair activations.
    Returns: (B, L, H*C) in pair.dtype.

    Any H and C, as the Pallas kernel: on the card, a shape past one
    launch's limits (H <= 16; C a multiple of 8, at most 192) is cut by
    `split_pair_attend` into several launches of the same kernel.
    """
    if not registry.on_device(pair):
        return ipa_pair_attend_plain(attn, pair)
    _lib.refuse_autograd('ipa_pair_attend', attn, pair)
    return split_pair_attend(attn.float(), pair, _launch)


def _launch(attn, pair):
    """One launch of csrc/ipa_attend.cu on a shape within its limits."""
    b, h, l, _ = attn.shape
    c = pair.shape[-1]
    dt = pair.dtype
    attn = attn.contiguous()
    pair = pair.contiguous()
    # What the launch needs, checked in one expression: the wrapper's host
    # work is a share of the kernel's time at this size.
    _lib.require(attn.is_cuda and pair.is_cuda and dt in _lib.DTYPE_CODE
                 and attn.dtype == torch.float32
                 and attn.shape == (b, h, l, l) and pair.shape == (b, l, l, c)
                 and h <= MAX_HEADS and c % 8 == 0 and c <= MAX_C,
                 f'ipa_pair_attend: attn (B, H, L, L) f32 with H <= '
                 f'{MAX_HEADS}, pair (B, L, L, C) on the card in f32 or '
                 f'bf16 with C a multiple of 8, at most {MAX_C}')
    out = torch.empty((b, l, h * c), dtype=dt, device=pair.device)
    err = _lib.lib().abx_ipa_pair_attend(
        _lib.DTYPE_CODE[dt], attn.data_ptr(), pair.data_ptr(),
        out.data_ptr(), b, h, l, c, _lib.stream(pair))
    _lib.check(err, 'ipa_pair_attend')
    ipa_pair_attend.launches += 1
    return out


ipa_pair_attend.launches = 0
