"""ESM2 protein language model (counterpart of abx_tpu/models/esm.py).

The score network is conditioned on frozen ESM2 embeddings of the noisy
antibody sequence, recomputed on every trunk pass.  As in the JAX package
the sequence is re-tokenised with integer index arithmetic
([cls | heavy | 48 x G | light | eos | pad]), and the learned
layer-weighted sum of the per-layer representations is accumulated in f32
inside the layer loop, so the (B, L, D, num_layers + 1) stack is never
built.  Under a profiler the forward is the span `abx.esm`, and each layer
is tiled by `abx.esm.norm` (each LayerNorm), `abx.esm.attn`
and `abx.esm.ffn` (each with its residual add); `abx.esm.mix` is each
step of the weighted sum.

Submodules carry fair-esm's names (`embed_tokens`, `layers.{i}.self_attn.
q_proj`, `layers.{i}.fc1`, `emb_layer_norm_after`, ...), so a fair-esm
state dict loads by name; `utils/params.py` maps the JAX package's tree
onto them.  Parameters live in the compute dtype (frozen weights), and a
Python loop over the layers replaces `nn.scan`.  The attention goes through
`ops/esm_attention.py` (the hand-written kernels on the card: by default
`esm_attention`; `ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1` takes the flash
route, `esm_flash_attention`, on the card and on the CPU alike); the
LayerNorms in eval mode on the card through `ops/esm_layer_norm.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import registry
from abx_tpu_torch.ops.esm_attention import (esm_attention,
                                             esm_attention_plain,
                                             esm_flash_attention)
from abx_tpu_torch.ops.esm_layer_norm import esm_layer_norm
from abx_tpu_torch.utils.prof import annotate, annotated

# ESM alphabet (fair-esm standard): ids of the special / aa tokens.
ESM_CLS, ESM_PAD, ESM_EOS, ESM_UNK, ESM_MASK = 0, 1, 2, 3, 32
_ESM_AA_ORDER = 'LAGVSERTIDPKQNFYMHWC'  # ids 4..23
ESM_TOKEN_OF_AA = {aa: i + 4 for i, aa in enumerate(_ESM_AA_ORDER)}
ESM_TOKEN_OF_AA['X'] = 24
ESM_GLY = ESM_TOKEN_OF_AA['G']

# Our aatype (residue_constants order, X=20) -> ESM token id.
AATYPE_TO_ESM = np.array(
    [ESM_TOKEN_OF_AA[a] for a in rc.restypes_with_x], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    num_layers: int = 36
    embed_dim: int = 2560
    attention_heads: int = 40
    alphabet_size: int = 33
    token_dropout: bool = True

    @staticmethod
    def t36_3B() -> 'ESM2Config':
        return ESM2Config(36, 2560, 40)

    @staticmethod
    def t33_650M() -> 'ESM2Config':
        return ESM2Config(33, 1280, 20)

    @staticmethod
    def t12_35M() -> 'ESM2Config':
        return ESM2Config(12, 480, 20)

    @staticmethod
    def tiny() -> 'ESM2Config':
        return ESM2Config(2, 64, 4)


# fair-esm ESM2 release head counts by embed_dim: every size uses 20 heads
# except 3B/15B (40).
_ESM2_HEADS_BY_DIM = {5120: 40, 2560: 40, 1280: 20, 640: 20, 480: 20,
                      320: 20}


def esm2_num_heads(embed_dim: int, override: Optional[int] = None) -> int:
    """Attention head count for a released ESM2 size (or explicit override)."""
    if override:
        return int(override)
    return _ESM2_HEADS_BY_DIM.get(int(embed_dim),
                                  max(1, int(embed_dim) // 64))


def rotary_sincos(seq_len: int, dim: int, dtype, device):
    """ESM-style rotary tables, frequencies duplicated (not interleaved),
    computed in f64 and rounded to the compute dtype."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.einsum('i,j->ij', np.arange(seq_len, dtype=np.float64),
                      inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=dtype, device=device),
            torch.tensor(np.sin(emb), dtype=dtype, device=device))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rotary(x, cos, sin):
    # x: (B, L, H, Dh) heads-minor; cos / sin: (L, Dh).
    return x * cos[None, :, None] + _rotate_half(x) * sin[None, :, None]


class ESMLayerNorm(nn.Module):
    """One-pass f32 LayerNorm with fair-esm's parameter names, rounded once
    to `out_dtype`.  In eval mode on the card, with the one-pass moments,
    it is one launch of `esm_layer_norm` (which raises on what its kernel
    does not take); otherwise its plain version, `modules.layer_norm`."""

    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                             device=device))
        self.eps = eps

    def forward(self, x, two_pass: bool = False, out_dtype=torch.float32):
        if not two_pass and registry.kernel_route(self, x):
            return esm_layer_norm(x, self.weight, self.bias, self.eps,
                                  out_dtype)
        return layer_norm(x, self.weight, self.bias, self.eps, out_dtype,
                          two_pass=two_pass)


def _row_parallel(linear: nn.Linear, x, tp_group):
    """`linear(x)`; under a tensor-parallel group (`linear` holds this
    rank's input rows of the weight) the partial products are summed over
    the group first and the bias is added once, after the reduction."""
    if tp_group is None:
        return linear(x)
    y = F.linear(x, linear.weight)
    dist.all_reduce(y, group=tp_group)
    return y + linear.bias


class ESMSelfAttention(nn.Module):
    """Under tensor parallelism (`tp_size` ranks of `tp_group`, see
    parallel/esm_tp.py) q / k / v hold this rank's output columns, so it
    runs heads / tp_size heads, and out_proj its input rows."""

    def __init__(self, config: ESM2Config, dtype, device=None,
                 tp_size: int = 1, tp_group=None):
        super().__init__()
        d = config.embed_dim
        d_loc = d // tp_size
        self.head_dim = d // config.attention_heads
        self.tp_group = tp_group
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(d, d_loc, **kw)
        self.k_proj = nn.Linear(d, d_loc, **kw)
        self.v_proj = nn.Linear(d, d_loc, **kw)
        self.out_proj = nn.Linear(d_loc, d, **kw)

    def forward(self, x, padding_mask, cos, sin):
        """x (B, L, D) in the compute dtype; padding_mask (B, L) bool."""
        b, l, _ = x.shape
        dh = self.head_dim
        # The head count comes from the local projection width: all heads
        # on one rank, heads / tp under tensor parallelism.
        h = self.q_proj.out_features // dh
        d = h * dh
        q = self.q_proj(x).view(b, l, h, dh)
        k = self.k_proj(x).view(b, l, h, dh)
        v = self.v_proj(x).view(b, l, h, dh)
        q = _apply_rotary(q, cos, sin) * (dh ** -0.5)
        k = _apply_rotary(k, cos, sin)
        # Head-major views; the kernel reads them through strides.
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        fused = registry.use_fused_esm_attention()
        if fused and registry.on_device(x):
            out = esm_attention(q, k, v, padding_mask)
        elif not fused and registry.use_flash_esm():
            # The stock flash kernel's function; on a CPU tensor the
            # wrapper is its plain version.
            out = esm_flash_attention(q, k, v, padding_mask)
        else:
            out = esm_attention_plain(q, k, v, padding_mask)
        return _row_parallel(self.out_proj,
                             out.transpose(1, 2).reshape(b, l, d),
                             self.tp_group)


class ESMLayer(nn.Module):
    """Pre-LN transformer layer: LN -> attention -> +res, LN -> fc1 ->
    exact GELU -> fc2 -> +res.  The two LNs are one-pass f32, eps 1e-5.
    Under tensor parallelism fc1 holds this rank's (4 D) / tp_size output
    columns and fc2 their input rows."""

    def __init__(self, config: ESM2Config, dtype, device=None,
                 tp_size: int = 1, tp_group=None):
        super().__init__()
        d = config.embed_dim
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.tp_group = tp_group
        self.self_attn_layer_norm = ESMLayerNorm(d, 1e-5, **kw)
        self.self_attn = ESMSelfAttention(config, tp_size=tp_size,
                                          tp_group=tp_group, **kw)
        self.final_layer_norm = ESMLayerNorm(d, 1e-5, **kw)
        self.fc1 = nn.Linear(d, 4 * d // tp_size, **kw)
        self.fc2 = nn.Linear(4 * d // tp_size, d, **kw)

    def forward(self, x, padding_mask, cos, sin):
        # In training the two LNs take the two-pass variance, as the JAX
        # trainer's `two_pass_layer_norm()` gives them (ESM's final LN is
        # a flax LayerNorm there, which the context does not reach).
        dt = self.dtype
        tp = self.training
        with annotate('abx.esm.norm'):
            h = self.self_attn_layer_norm(x, tp, dt)
        with annotate('abx.esm.attn'):
            x = x + self.self_attn(h, padding_mask, cos, sin)
        with annotate('abx.esm.norm'):
            h = self.final_layer_norm(x, tp, dt)
        with annotate('abx.esm.ffn'):
            y = F.gelu(self.fc1(h))
            return x + _row_parallel(self.fc2, y, self.tp_group)


class ESM2(nn.Module):
    """ESM2 encoder.  For the 3B model, build it on the 'meta' device and
    give it weights with `utils/params.load_esm_params` or
    `cli/runner._random_esm`: nothing is allocated on the host.
    `tp_size` / `tp_group`: the layers' tensor-parallel shards
    (parallel/esm_tp.py)."""

    def __init__(self, config: ESM2Config, dtype=torch.float32, device=None,
                 tp_size: int = 1, tp_group=None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.embed_tokens = nn.Embedding(c.alphabet_size, c.embed_dim, **kw)
        self.layers = nn.ModuleList(
            ESMLayer(c, tp_size=tp_size, tp_group=tp_group, **kw)
            for _ in range(c.num_layers))
        # A flax nn.LayerNorm in the JAX package: eps 1e-6.
        self.emb_layer_norm_after = ESMLayerNorm(c.embed_dim, 1e-6, **kw)

    def forward(self, tokens, final_only: bool = False, layer_weights=None):
        """tokens (B, L) int -> per-layer representations:
          * `layer_weights` (num_layers+1,) given: the weighted sum over the
            per-layer representations, in f32: (B, L, D);
          * `final_only`: the post-LN last layer (B, L, D);
          * otherwise the full (B, L, D, num_layers+1) stack (small models
            and tests only)."""
        c = self.config
        dt = self.dtype
        padding_mask = tokens == ESM_PAD
        x = self.embed_tokens(tokens.long()).to(dt)
        if c.token_dropout:
            # Inference-time token-dropout rescale (fair-esm esm2.py).
            is_mask = tokens == ESM_MASK
            x = torch.where(is_mask[..., None], torch.zeros_like(x), x)
            mask_ratio_train = 0.15 * 0.8
            src_lengths = (~padding_mask).sum(-1).clamp(min=1)
            mask_ratio_obs = is_mask.sum(-1).float() / src_lengths
            x = x * ((1 - mask_ratio_train)
                     / (1 - mask_ratio_obs))[:, None, None].to(dt)
        x = torch.where(padding_mask[..., None], torch.zeros_like(x), x)
        cos, sin = rotary_sincos(tokens.shape[1],
                                 c.embed_dim // c.attention_heads, dt,
                                 tokens.device)

        weighted = layer_weights is not None
        if weighted:
            with annotate('abx.esm.mix'):
                lw = layer_weights.float()
                acc = lw[0] * x.float()
        reprs = [x] if not (weighted or final_only) else None
        for i, layer in enumerate(self.layers):
            # ESM is frozen: its layers never enter the autograd graph.
            # Only the weighted sum does, so the gradient of layer weight
            # i is the representation x_i (and that of the last, the
            # post-LN final).
            with torch.no_grad():
                x = layer(x, padding_mask, cos, sin)
            if weighted:
                with annotate('abx.esm.mix'):
                    acc = acc + lw[i + 1] * x.float()
            if reprs is not None:
                reprs.append(x)
        # The final LN applies to the last layer's representation only.
        with torch.no_grad(), annotate('abx.esm.norm'):
            final = self.emb_layer_norm_after(x, out_dtype=dt)
        if weighted:
            # acc holds w[-1] * x_raw; swap in the post-LN final.
            with annotate('abx.esm.mix'):
                return acc + lw[-1] * (final.float() - x.float())
        if final_only:
            return final
        # Full stack: [embedding, layers 1..n-1, post-LN final].
        return torch.stack(reprs[:-1] + [final], dim=-1)


class ESM2LMHead(nn.Module):
    """Masked-LM head (fair-esm RobertaLMHead; `abx_tpu/models/esm.py:524`):
    dense -> exact GELU -> LayerNorm in f32 (eps 1e-6, the flax default the
    JAX package takes, where fair-esm uses 1e-5) -> the projection tied to
    the encoder's token embedding, `x @ embed_weight.T` + bias.  It holds
    no projection of its own: the caller passes `embed_weight`, as the JAX
    CLI passes `embed_tokens`' table (`utils/params.load_lm_head_params`
    says what happens to a checkpoint's `lm_head.weight`)."""

    def __init__(self, config: ESM2Config, dtype=torch.float32, device=None):
        super().__init__()
        d = config.embed_dim
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.dense = nn.Linear(d, d, **kw)
        self.layer_norm = ESMLayerNorm(d, 1e-6, **kw)
        self.bias = nn.Parameter(torch.zeros(config.alphabet_size, **kw))

    def forward(self, features, embed_weight):
        """features (B, L, D) -> logits (B, L, alphabet_size)."""
        x = F.gelu(self.dense(features))
        x = self.layer_norm(x, out_dtype=self.dtype)
        return x @ embed_weight.t().to(self.dtype) + self.bias


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
    # Antibody gather index: heavy at p-1, light at p-1-sep.
    ab_idx = torch.where(in_light, pos - 1 - sep_pad_num, pos - 1)
    ab_tok = torch.gather(aa_esm, 1, ab_idx.clamp(0, l_ab - 1).expand(b, -1))
    tokens = torch.full((b, l_esm), ESM_PAD, dtype=torch.long, device=dev)
    tokens = torch.where(pos == 0, ESM_CLS, tokens)
    tokens = torch.where(in_heavy | in_light, ab_tok, tokens)
    tokens = torch.where(in_linker, ESM_GLY, tokens)
    return torch.where(is_eos, ESM_EOS, tokens)


def extract_antibody_reprs(reprs, heavy_len, light_len, l_ab: int,
                           sep_pad_num: int = 48):
    """Inverse of build_esm_tokens: gather the antibody positions, drop the
    linker, zero the padded antibody rows.  Works on the full stack
    (B, L_esm, D, N) and on the weighted (B, L_esm, D) representation."""
    dev = reprs.device
    b = reprs.shape[0]
    ab_pos = torch.arange(l_ab, device=dev)[None, :]
    h = heavy_len.long()[:, None]
    esm_pos = torch.where(ab_pos < h, ab_pos + 1, ab_pos + 1 + sep_pad_num)
    esm_pos = esm_pos.clamp(0, reprs.shape[1] - 1)
    trailing = reprs.shape[2:]
    idx = esm_pos.reshape(esm_pos.shape + (1,) * len(trailing))
    out = torch.gather(reprs, 1, idx.expand(b, l_ab, *trailing))
    valid = ab_pos < h + light_len.long()[:, None]
    valid = valid.reshape(valid.shape + (1,) * len(trailing))
    return torch.where(valid, out, torch.zeros_like(out))


class AntibodyESM(nn.Module):
    """Noisy antibody aatype -> ESM embeddings: integer retokenisation,
    the ESM2 forward (`module`), and the inverse gather."""

    def __init__(self, config: ESM2Config, antibody_len: int,
                 sep_pad_num: int = 48, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.config = config
        self.antibody_len = antibody_len
        self.sep_pad_num = sep_pad_num
        self.module = ESM2(config, dtype=dtype, device=device)

    def esm_seq_len(self) -> int:
        return self.antibody_len + self.sep_pad_num + 2

    @annotated('abx.esm')
    def forward(self, ab_aatype, heavy_len, light_len, layer_weights=None):
        """Returns (B, L_ab, D) in f32 when `layer_weights` is given, else
        (B, L_ab, D, num_layers+1)."""
        tokens = build_esm_tokens(ab_aatype, heavy_len, light_len,
                                  self.sep_pad_num)
        reprs = self.module(tokens, layer_weights=layer_weights)
        return extract_antibody_reprs(reprs, heavy_len, light_len,
                                      self.antibody_len, self.sep_pad_num)
