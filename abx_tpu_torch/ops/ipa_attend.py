"""IPA attend-over-pair: out[b, i, (h c)] = sum_j attn[b,h,i,j] pair[b,i,j,c].

Counterpart of abx_tpu/ops/ipa_attend.py::ipa_pair_attend (the Pallas TPU
kernel), taken by the IPA's non-fused route (`ABX_FUSED_IPA_ATTN=0`) when
`ABX_IPA_ATTEND=1`.  On the card this runs `csrc/ipa_attend.cu`: one block
per query row contracts the (H x J) attention rows with that query's own
(J x C) pair row, reading the pair track once; the f32 attention is
rounded to the pair dtype while it is staged.  See the source note there
for what bounds it.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.ops import _lib, registry

MAX_HEADS = 16  # one wmma M tile (csrc/ipa_attend.cu kHeads)


def ipa_pair_attend_plain(attn, pair):
    """Plain PyTorch version (mirrors ipa_pair_attend_reference)."""
    out = torch.einsum('bhij,bijc->bihc', attn.to(pair.dtype), pair)
    b, l, h, c = out.shape
    return out.reshape(b, l, h * c)


def ipa_pair_attend(attn, pair):
    """out[b,i,(h c)] = sum_j attn[b,h,i,j] * pair[b,i,j,c].

    Args:
        attn: (B, H, L, L) attention probabilities (f32 on the kernel
            route; H <= 16).
        pair: (B, L, L, C) pair activations.
    Returns: (B, L, H*C) in pair.dtype.
    """
    if not registry.on_device(pair):
        return ipa_pair_attend_plain(attn, pair)
    b, h, l, _ = attn.shape
    c = pair.shape[-1]
    dt = pair.dtype
    attn = attn.float().contiguous()
    pair = pair.contiguous()
    _lib.check_cuda_inputs('ipa_pair_attend', dt, pair=pair,
                           f32=dict(attn=attn))
    _lib.require(attn.shape == (b, h, l, l) and pair.shape == (b, l, l, c),
                 'ipa_pair_attend: attn (B, H, L, L), pair (B, L, L, C)')
    _lib.require(h <= MAX_HEADS,
                 f'ipa_pair_attend: at most {MAX_HEADS} heads, got {h}')
    out = torch.empty((b, l, h * c), dtype=dt, device=pair.device)
    err = _lib.lib().abx_ipa_pair_attend(
        _lib.DTYPE_CODE[dt], attn.data_ptr(), pair.data_ptr(),
        out.data_ptr(), b, h, l, c, _lib.stream(pair))
    _lib.check(err, 'ipa_pair_attend')
    ipa_pair_attend.launches += 1
    return out


ipa_pair_attend.launches = 0
