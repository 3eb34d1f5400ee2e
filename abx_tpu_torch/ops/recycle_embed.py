"""Fused pair-track recycling assembly.

Counterpart of abx_tpu/ops/recycle_embed.py::recycle_embed (the Pallas TPU
kernel): concat(static pair, time vector) + LayerNorm(prev_pair) + the
distogram-bin embedding of the previous positions, in one pass over the
pair track.  On the card this runs `csrc/recycle_embed.cu`; see the source
note there for what bounds it.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


def recycle_embed_plain(static_pair, t_vec, prev_pair, ln_scale, ln_bias,
                        table, bins, eps: float = 1e-5):
    """Plain PyTorch version (mirrors recycle_embed_reference): every term
    in f32, one cast to prev_pair.dtype at the end."""
    b, l = static_pair.shape[:2]
    c0, c = static_pair.shape[-1], prev_pair.shape[-1]
    ln = layer_norm(prev_pair, ln_scale, ln_bias, eps)
    emb = table.float()[bins.long()]
    hi = t_vec.float()[:, None, None, :].expand(b, l, l, c - c0)
    base = torch.cat([static_pair.float(), hi], dim=-1)
    return (base + ln + emb).to(prev_pair.dtype)


def recycle_embed(static_pair, t_vec, prev_pair, ln_scale, ln_bias, table,
                  bins):
    """concat(static_pair, t_vec) + LN(prev_pair) + table[bins].

    Args:
        static_pair: (B, L, L, C0) trajectory-static pair embedding.
        t_vec: (B, C - C0) per-batch time embedding (channels C0..C-1).
        prev_pair: (B, L, L, C) recycling carry.
        ln_scale, ln_bias: (C,) prev_pair LayerNorm params.
        table: (num_bins, C) distogram-bin embedding table.
        bins: (B, L, L) integer distogram bins of the previous positions.
    Returns: (B, L, L, C) in prev_pair.dtype.
    """
    if not registry.on_device(prev_pair):
        return recycle_embed_plain(static_pair, t_vec, prev_pair, ln_scale,
                                   ln_bias, table, bins)
    b, l, _, c = prev_pair.shape
    c0 = static_pair.shape[-1]
    n_bins = table.shape[0]
    dt = prev_pair.dtype
    static_pair = static_pair.to(dt).contiguous()
    t_vec = t_vec.float().contiguous()
    f32 = [p.float().contiguous() for p in (ln_scale, ln_bias, table)]
    bins = bins.long().contiguous()
    _lib.check_cuda_inputs('recycle_embed', dt, static_pair=static_pair,
                           prev_pair=prev_pair,
                           f32=dict(t_vec=t_vec, ln_scale=f32[0],
                                    ln_bias=f32[1], table=f32[2]),
                           i64=dict(bins=bins))
    _lib.require(static_pair.shape == (b, l, l, c0) and c0 < c
                 and t_vec.shape == (b, c - c0)
                 and prev_pair.shape == (b, l, l, c)
                 and f32[0].shape == f32[1].shape == (c,)
                 and f32[2].shape == (n_bins, c) and bins.shape == (b, l, l),
                 'recycle_embed: static_pair (B, L, L, C0), t_vec (B, C-C0), '
                 'prev_pair (B, L, L, C), LN (C,), table (bins, C), '
                 'bins (B, L, L)')
    out = torch.empty_like(prev_pair)
    err = _lib.lib().abx_recycle_embed(
        _lib.DTYPE_CODE[dt], static_pair.data_ptr(), t_vec.data_ptr(),
        prev_pair.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
        f32[2].data_ptr(), bins.data_ptr(), out.data_ptr(), b * l * l, c0, c,
        l * l, n_bins, _lib.stream(prev_pair))
    _lib.check(err, 'recycle_embed')
    recycle_embed.launches += 1
    return out


recycle_embed.launches = 0
