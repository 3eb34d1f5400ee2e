"""ESM2 of the reference model, in float32 (fair-esm's `ESM2` forward:
token-dropout rescale, pre-LN layers with rotary attention and exact GELU,
the post-LN final), with fair-esm's parameter names, the antibody
re-tokenisation ([cls | heavy | 48 x G | light | eos | pad]) and the
learned layer-weighted sum of the per-layer representations.

The weights may be stored in bfloat16 (as the benchmark makes them): each
product casts its weight to float32 at the call, so the 3B model is never
held in float32 whole.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import residue_constants as rc
from benchmark.reference.modules import layer_norm, linear

ESM_CLS, ESM_PAD, ESM_EOS, ESM_MASK = 0, 1, 2, 32
_ESM_AA_ORDER = 'LAGVSERTIDPKQNFYMHWC'  # ids 4..23
ESM_TOKEN_OF_AA = {aa: i + 4 for i, aa in enumerate(_ESM_AA_ORDER)}
ESM_TOKEN_OF_AA['X'] = 24
ESM_GLY = ESM_TOKEN_OF_AA['G']
AATYPE_TO_ESM = np.array(
    [ESM_TOKEN_OF_AA[a] for a in rc.restypes_with_x], dtype=np.int64)
BIG_NEG = -1e9


def rotary_sincos(seq_len: int, dim: int, device):
    """Rotary tables, frequencies duplicated (not interleaved)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.einsum('i,j->ij', np.arange(seq_len, dtype=np.float64),
                      inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rotary(x, cos, sin):
    return x * cos[None, :, None] + _rotate_half(x) * sin[None, :, None]


class _Norm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class _Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class ESMSelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = _Linear(d, d)
        self.k_proj = _Linear(d, d)
        self.v_proj = _Linear(d, d)
        self.out_proj = _Linear(d, d)

    def forward(self, x, padding_mask, cos, sin):
        b, l, d = x.shape
        h = self.heads
        dh = d // h
        q = _apply_rotary(self.q_proj(x).view(b, l, h, dh), cos, sin) \
            * (dh ** -0.5)
        k = _apply_rotary(self.k_proj(x).view(b, l, h, dh), cos, sin)
        v = self.v_proj(x).view(b, l, h, dh)
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
        logits = logits + padding_mask.float()[:, None, None, :] * BIG_NEG
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum('bhqk,bkhd->bqhd', probs, v).reshape(b, l, d)
        return self.out_proj(out)


class ESMLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.self_attn_layer_norm = _Norm(d, 1e-5)
        self.self_attn = ESMSelfAttention(d, heads)
        self.final_layer_norm = _Norm(d, 1e-5)
        self.fc1 = _Linear(d, 4 * d)
        self.fc2 = _Linear(4 * d, d)

    def forward(self, x, padding_mask, cos, sin):
        x = x + self.self_attn(self.self_attn_layer_norm(x), padding_mask,
                               cos, sin)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class ESM2(nn.Module):
    def __init__(self, num_layers: int, d: int, heads: int,
                 alphabet_size: int = 33):
        super().__init__()
        self.embed_tokens = nn.Embedding(alphabet_size, d)
        self.layers = nn.ModuleList(ESMLayer(d, heads)
                                    for _ in range(num_layers))
        self.emb_layer_norm_after = _Norm(d, 1e-6)
        self.heads = heads

    def forward(self, tokens, layer_weights):
        """tokens (B, L) -> the layer-weighted sum (B, L, D) over the
        embedding, layers 1..n-1 and the post-LN final."""
        padding_mask = tokens == ESM_PAD
        x = self.embed_tokens.weight.float()[tokens.long()]
        is_mask = tokens == ESM_MASK
        x = torch.where(is_mask[..., None], torch.zeros_like(x), x)
        src_lengths = (~padding_mask).sum(-1).clamp(min=1)
        mask_ratio_obs = is_mask.sum(-1).float() / src_lengths
        x = x * ((1 - 0.15 * 0.8) / (1 - mask_ratio_obs))[:, None, None]
        x = torch.where(padding_mask[..., None], torch.zeros_like(x), x)
        d = x.shape[-1]
        cos, sin = rotary_sincos(tokens.shape[1], d // self.heads,
                                 tokens.device)
        lw = layer_weights.float()
        acc = lw[0] * x
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x, padding_mask, cos, sin)
            if i < n - 1:
                acc = acc + lw[i + 1] * x
        return acc + lw[-1] * self.emb_layer_norm_after(x)


def build_esm_tokens(ab_aatype, heavy_len, light_len, sep_pad_num: int = 48):
    """(B, L_ab) aatype -> (B, L_ab+sep+2) ESM tokens, linker-joined."""
    b, l_ab = ab_aatype.shape
    dev = ab_aatype.device
    l_esm = l_ab + sep_pad_num + 2
    aa_esm = torch.as_tensor(AATYPE_TO_ESM, device=dev)[
        ab_aatype.long().clamp(0, rc.restype_num)]
    pos = torch.arange(l_esm, device=dev)[None, :]
    h = heavy_len.long()[:, None]
    lt = light_len.long()[:, None]
    in_heavy = (pos >= 1) & (pos <= h)
    in_linker = (pos > h) & (pos <= h + sep_pad_num)
    in_light = (pos > h + sep_pad_num) & (pos <= h + sep_pad_num + lt)
    is_eos = pos == h + sep_pad_num + lt + 1
    ab_idx = torch.where(in_light, pos - 1 - sep_pad_num, pos - 1)
    ab_tok = torch.gather(aa_esm, 1, ab_idx.clamp(0, l_ab - 1).expand(b, -1))
    tokens = torch.full((b, l_esm), ESM_PAD, dtype=torch.long, device=dev)
    tokens = torch.where(pos == 0, ESM_CLS, tokens)
    tokens = torch.where(in_heavy | in_light, ab_tok, tokens)
    tokens = torch.where(in_linker, ESM_GLY, tokens)
    return torch.where(is_eos, ESM_EOS, tokens)


def extract_antibody_reprs(reprs, heavy_len, light_len, l_ab: int,
                           sep_pad_num: int = 48):
    """Gather the antibody positions of (B, L_esm, D), drop the linker,
    zero the padded antibody rows."""
    dev = reprs.device
    b = reprs.shape[0]
    ab_pos = torch.arange(l_ab, device=dev)[None, :]
    h = heavy_len.long()[:, None]
    esm_pos = torch.where(ab_pos < h, ab_pos + 1, ab_pos + 1 + sep_pad_num)
    esm_pos = esm_pos.clamp(0, reprs.shape[1] - 1)
    idx = esm_pos[..., None].expand(b, l_ab, reprs.shape[-1])
    out = torch.gather(reprs, 1, idx)
    valid = (ab_pos < h + light_len.long()[:, None])[..., None]
    return torch.where(valid, out, torch.zeros_like(out))


class AntibodyESM(nn.Module):
    """Noisy antibody aatype -> the weighted ESM2 embedding (B, L_ab, D)."""

    def __init__(self, num_layers: int, d: int, heads: int,
                 antibody_len: int, sep_pad_num: int = 48):
        super().__init__()
        self.antibody_len = antibody_len
        self.sep_pad_num = sep_pad_num
        self.module = ESM2(num_layers, d, heads)

    def forward(self, ab_aatype, heavy_len, light_len, layer_weights):
        tokens = build_esm_tokens(ab_aatype, heavy_len, light_len,
                                  self.sep_pad_num)
        reprs = self.module(tokens, layer_weights)
        return extract_antibody_reprs(reprs, heavy_len, light_len,
                                      self.antibody_len, self.sep_pad_num)
