"""Fused pair-track recycling assembly.

Counterpart of abx_tpu/ops/recycle_embed.py::recycle_embed (the Pallas TPU
kernel): concat(static pair, time vector) + LayerNorm(prev_pair) + the
distogram-bin embedding of the previous positions, in one pass over the
pair track.  On the card this runs `csrc/recycle_embed.cu`; see the source
note there for what bounds it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry


class RecyclePack(NamedTuple):
    """recycle_embed's parameters as the kernel takes them: the LayerNorm
    params and the (num_bins, C) table in f32."""
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    table: torch.Tensor


def pack_recycle(ln_scale, ln_bias, table) -> RecyclePack:
    return RecyclePack(*(p.float().contiguous()
                         for p in (ln_scale, ln_bias, table)))


def recycle_embed_plain(static_pair, t_vec, prev_pair, ln_scale, ln_bias,
                        table, bins, eps: float = 1e-5, packed=None):
    """Plain PyTorch version (mirrors recycle_embed_reference): every term
    in f32, one cast to prev_pair.dtype at the end; t_vec repeated along
    channels C0..C-1 as often as it fits; an out-of-range bin adds zero, as
    the Pallas kernel's one-hot product does.  `packed` (the kernel's
    params) is not used."""
    b, l = static_pair.shape[:2]
    c0, c = static_pair.shape[-1], prev_pair.shape[-1]
    ln = layer_norm(prev_pair, ln_scale, ln_bias, eps)
    n_bins = table.shape[0]
    bins = bins.long()
    in_range = ((bins >= 0) & (bins < n_bins)).float()[..., None]
    emb = table.float()[bins.clamp(0, n_bins - 1)] * in_range
    tv = t_vec.float().repeat(1, (c - c0) // t_vec.shape[-1])
    hi = tv[:, None, None, :].expand(b, l, l, c - c0)
    base = torch.cat([static_pair.float(), hi], dim=-1)
    return (base + ln + emb).to(prev_pair.dtype)


def recycle_embed(static_pair, t_vec, prev_pair, ln_scale, ln_bias, table,
                  bins, packed: RecyclePack | None = None):
    """concat(static_pair, t_vec) + LN(prev_pair) + table[bins].

    Args:
        static_pair: (B, L, L, C0) trajectory-static pair embedding.
        t_vec: (B, T) per-batch time embedding, T dividing C - C0: it is
            repeated (C - C0) / T times over channels C0..C-1 (the model
            hands in its embedding once for the two index-embed blocks).
        prev_pair: (B, L, L, C) recycling carry.
        ln_scale, ln_bias: (C,) prev_pair LayerNorm params.
        table: (num_bins, C) distogram-bin embedding table.
        bins: (B, L, L) integer distogram bins of the previous positions.
        packed: the params as `pack_recycle` makes them (a module caches
            it, so a call launches the kernel alone); made here when None.
    Returns: (B, L, L, C) in prev_pair.dtype.
    """
    if not registry.on_device(prev_pair):
        return recycle_embed_plain(static_pair, t_vec, prev_pair, ln_scale,
                                   ln_bias, table, bins)
    _lib.refuse_autograd('recycle_embed', static_pair, t_vec, prev_pair,
                         ln_scale, ln_bias, table)
    b, l, _, c = prev_pair.shape
    c0 = static_pair.shape[-1]
    n_bins = table.shape[0]
    dt = prev_pair.dtype
    if packed is None:
        packed = pack_recycle(ln_scale, ln_bias, table)
    static_pair = static_pair.to(dt).contiguous()
    if t_vec.dtype not in (torch.float32, dt):
        t_vec = t_vec.float()
    t_vec = t_vec.contiguous()
    bins = bins.long().contiguous()
    _lib.check_cuda_inputs('recycle_embed', dt, static_pair=static_pair,
                           prev_pair=prev_pair,
                           f32=dict(ln_scale=packed.ln_scale,
                                    ln_bias=packed.ln_bias,
                                    table=packed.table),
                           i64=dict(bins=bins))
    _lib.require(t_vec.is_cuda, 'recycle_embed: t_vec is not on a CUDA '
                 'device')
    _lib.require(static_pair.shape == (b, l, l, c0) and c0 < c <= 256
                 and t_vec.dim() == 2 and t_vec.shape[0] == b
                 and 0 < t_vec.shape[1] and (c - c0) % t_vec.shape[1] == 0
                 and prev_pair.shape == (b, l, l, c)
                 and packed.ln_scale.shape == packed.ln_bias.shape == (c,)
                 and packed.table.shape == (n_bins, c)
                 and bins.shape == (b, l, l),
                 'recycle_embed: static_pair (B, L, L, C0), t_vec (B, T) '
                 'with T dividing C-C0, prev_pair (B, L, L, C) with C <= '
                 '256, LN (C,), table (bins, C), bins (B, L, L)')
    out = torch.empty_like(prev_pair)
    err = _lib.lib().abx_recycle_embed(
        _lib.DTYPE_CODE[dt], static_pair.data_ptr(), t_vec.data_ptr(),
        int(t_vec.dtype == torch.float32), t_vec.shape[1],
        prev_pair.data_ptr(), packed.ln_scale.data_ptr(),
        packed.ln_bias.data_ptr(), packed.table.data_ptr(), bins.data_ptr(),
        out.data_ptr(), b * l * l, c0, c, l * l, n_bins,
        _lib.stream(prev_pair))
    _lib.check(err, 'recycle_embed')
    recycle_embed.launches += 1
    return out


recycle_embed.launches = 0
