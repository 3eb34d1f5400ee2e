"""The Seqformer trunk of the reference model (single + pair tracks) and its
input embedding, in float32: plain attention, triangle multiplication and
transitions, in the order and with the parameter names of the port's
modules, and the layer-weighted ESM2 embedding added to the antibody
track when `esm.enabled`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference import residue_constants as rc
from benchmark.reference.encoder import PairEmbedding, ResidueEmbedding
from benchmark.reference.modules import (MLP, Embedding, LayerNorm, Linear,
                                         get_timestep_embedding)

BIG_NEG = -1e9


def pair_concat(pair_1, pair_2):
    """Block-diagonal pair assembly."""
    b, l1, _, c = pair_1.shape
    l2 = pair_2.shape[1]
    top = torch.cat([pair_1, pair_1.new_zeros((b, l1, l2, c))], dim=2)
    bottom = torch.cat([pair_2.new_zeros((b, l2, l1, c)), pair_2], dim=2)
    return torch.cat([top, bottom], dim=1)


class GatedAttention(nn.Module):
    """Multi-head self-attention with pair bias, gating and key mask, on
    (B, S, Q, C) with a broadcast rows axis S."""

    def __init__(self, c_in: int, key_dim: int, value_dim: int,
                 output_dim: int, num_head: int, gating: bool = True,
                 split_first: bool = True):
        super().__init__()
        self.num_head = num_head
        self.key_dim, self.value_dim = key_dim, value_dim
        self.gating = gating
        self.split_first = split_first
        if split_first:
            self.proj_q = Linear(c_in, key_dim, bias=False)
            self.proj_k = Linear(c_in, key_dim, bias=False)
            self.proj_v = Linear(c_in, value_dim, bias=False)
        else:
            # Per-head [q | k | v] row blocks.
            self.proj_in = Linear(c_in, key_dim * 3, bias=False)
        if gating:
            self.gate = Linear(c_in, value_dim)
        self.proj_out = Linear(value_dim, output_dim)

    def forward(self, q_data, bias, k_mask):
        """q_data (B, S, Q, C); bias (B, H, Q, K); k_mask (B, 1, K)."""
        h = self.num_head
        key_dim = self.key_dim // h
        value_dim = self.value_dim // h
        if self.split_first:
            q = self.proj_q(q_data).reshape(q_data.shape[:-1] + (h, key_dim))
            k = self.proj_k(q_data).reshape(q_data.shape[:-1] + (h, key_dim))
            v = self.proj_v(q_data).reshape(q_data.shape[:-1]
                                            + (h, value_dim))
        else:
            qkv = self.proj_in(q_data)
            qkv = qkv.reshape(qkv.shape[:-1] + (h, 3 * key_dim))
            q, k, v = torch.split(qkv, key_dim, dim=-1)
        q = q * (key_dim ** -0.5)
        logits = torch.einsum('...qhd,...khd->...hqk', q, k)
        logits = logits + bias[:, None].float()
        logits = logits + (1.0 - k_mask[:, :, None, None, :].float()) * BIG_NEG
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum('...hqk,...khd->...qhd', weights, v)
        out = out.reshape(out.shape[:-2] + (self.value_dim,))
        if self.gating:
            out = out * torch.sigmoid(self.gate(q_data))
        return self.proj_out(out)


class SeqAttentionWithPairBias(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int):
        super().__init__()
        self.seq_norm = LayerNorm(seq_c)
        self.pair_norm = LayerNorm(pair_c)
        self.proj_pair = Linear(pair_c, config.num_head, bias=False)
        self.attn = GatedAttention(seq_c, seq_c, seq_c, seq_c,
                                   config.num_head, split_first=False)

    def forward(self, seq_act, pair_act, mask):
        bias = self.proj_pair(self.pair_norm(pair_act)).permute(0, 3, 1, 2)
        return self.attn(self.seq_norm(seq_act)[:, None], bias,
                         mask[:, None])[:, 0]


class Transition(nn.Module):
    def __init__(self, config, num_in: int):
        super().__init__()
        n_mid = num_in * config.num_intermediate_factor
        self.norm = LayerNorm(num_in)
        self.in_proj = Linear(num_in, n_mid)
        self.out_proj = Linear(n_mid, num_in)

    def forward(self, act):
        return self.out_proj(torch.relu(self.in_proj(self.norm(act))))


class OuterProductMean(nn.Module):
    """ESMFold-style outer product + difference."""

    def __init__(self, config, num_in: int, num_out: int):
        super().__init__()
        noc = config.num_outer_channel
        self.norm = LayerNorm(num_in)
        self.left_proj = Linear(num_in, noc)
        self.right_proj = Linear(num_in, noc)
        self.out_proj = Linear(2 * noc, num_out)

    def forward(self, act, mask):
        mask_col = mask[..., None].float()
        act = self.norm(act)
        left = mask_col * self.left_proj(act)
        right = mask_col * self.right_proj(act)
        prod = left[:, None, :, :] * right[:, :, None, :]
        diff = left[:, None, :, :] - right[:, :, None, :]
        return self.out_proj(torch.cat([prod, diff], dim=-1))


class TriangleMultiplication(nn.Module):
    def __init__(self, config, num_in: int):
        super().__init__()
        nc = config.num_intermediate_channel
        self.per_row = config.orientation == 'per_row'
        self.gating = config.gating
        self.norm = LayerNorm(num_in)
        self.left_proj = Linear(num_in, nc)
        self.right_proj = Linear(num_in, nc)
        if self.gating:
            self.left_gate = Linear(num_in, nc)
            self.right_gate = Linear(num_in, nc)
            self.final_gate = Linear(num_in, num_in)
        self.final_norm = LayerNorm(nc)
        self.proj_out = Linear(nc, num_in)

    def forward(self, act, mask):
        pair_mask = (mask[:, :, None, None] * mask[:, None, :, None]).float()
        x = self.norm(act)
        left = self.left_proj(x)
        right = self.right_proj(x)
        if self.gating:
            left = left * torch.sigmoid(self.left_gate(x))
            right = right * torch.sigmoid(self.right_gate(x))
        left = left * pair_mask
        right = right * pair_mask
        if self.per_row:
            out = torch.einsum('bikc,bjkc->bijc', left, right)
        else:
            out = torch.einsum('bkic,bkjc->bijc', left, right)
        out = self.proj_out(self.final_norm(out))
        if self.gating:
            out = out * torch.sigmoid(self.final_gate(x))
        return out


class TriangleAttention(nn.Module):
    def __init__(self, config, c_in: int):
        super().__init__()
        self.per_column = config.orientation == 'per_column'
        self.norm = LayerNorm(c_in)
        self.proj_pair = Linear(c_in, config.num_head, bias=False)
        self.attn = GatedAttention(c_in, c_in, c_in, c_in, config.num_head,
                                   gating=config.gating)

    def forward(self, pair_act, seq_mask):
        x = pair_act
        if self.per_column:
            x = x.transpose(1, 2)
        xn = self.norm(x)
        bias = self.proj_pair(xn).permute(0, 3, 1, 2)
        out = self.attn(xn, bias, seq_mask[:, None])
        if self.per_column:
            out = out.transpose(1, 2)
        return out


class SeqformerIteration(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int):
        super().__init__()
        c = config
        self.seq_attn = SeqAttentionWithPairBias(
            c.seq_attention_with_pair_bias, seq_c, pair_c)
        self.seq_transition = Transition(c.seq_transition, seq_c)
        self.outer_product_mean = OuterProductMean(c.outer_product_mean,
                                                   seq_c, pair_c)
        self.tri_mul_out = TriangleMultiplication(
            c.triangle_multiplication_outgoing, pair_c)
        self.tri_mul_in = TriangleMultiplication(
            c.triangle_multiplication_incoming, pair_c)
        self.tri_attn_start = TriangleAttention(
            c.triangle_attention_starting_node, pair_c)
        self.tri_attn_end = TriangleAttention(
            c.triangle_attention_ending_node, pair_c)
        self.pair_transition = Transition(c.pair_transition, pair_c)

    def forward(self, seq_act, pair_act, seq_mask):
        seq_act = seq_act + self.seq_attn(seq_act, pair_act, seq_mask)
        seq_act = seq_act + self.seq_transition(seq_act)
        pair_act = pair_act + self.outer_product_mean(seq_act, seq_mask)
        for module in (self.tri_mul_out, self.tri_mul_in,
                       self.tri_attn_start, self.tri_attn_end):
            pair_act = pair_act + module(pair_act, seq_mask)
        return seq_act, pair_act + self.pair_transition(pair_act)


class Seqformer(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int):
        super().__init__()
        self.num_block = config.seqformer_num_block
        for i in range(self.num_block):
            self.add_module(f'block_{i}', SeqformerIteration(
                config.seqformer, seq_c, pair_c))

    def forward(self, seq_act, pair_act, mask):
        for i in range(self.num_block):
            seq_act, pair_act = getattr(self, f'block_{i}')(
                seq_act, pair_act, mask)
        return seq_act, pair_act


class EmbeddingAndSeqformer(nn.Module):
    """Input embedding + trunk.  The antibody block occupies positions
    [0, antibody_len) and the antigen block [antibody_len, L)."""

    def __init__(self, config, antibody_len: int):
        super().__init__()
        c = config
        self.config = c
        self.antibody_len = antibody_len
        num_token = rc.restype_num + 3
        sc, pc, ie = c.seq_channel, c.pair_channel, c.index_embed_size
        self.proj_aa_type = Embedding(num_token, sc,
                                      padding_idx=rc.unk_restype_index)
        self.proj_rel_pos = Embedding(c.max_relative_feature * 2 + 2, pc)
        if c.esm.enabled:
            self.esm_embed_weights = nn.Parameter(
                torch.zeros(c.esm.num_layers + 1))
            self.esm_norm = LayerNorm(c.esm.embed_channel)
            self.proj_esm_embed = MLP(c.esm.embed_channel, (sc, sc))
        self.aa_proj_norm = LayerNorm(sc)
        self.aa_proj = MLP(sc, (sc, sc))
        self.encode_residue_emb = ResidueEmbedding(sc)
        self.encode_pair_emb = PairEmbedding(
            pc, dgram_num_bins=c.prev_pos.num_bins,
            dgram_min_bin=c.prev_pos.min_bin,
            dgram_max_bin=c.prev_pos.max_bin)
        seq_full, pair_full = sc + ie, pc + 2 * ie
        self.prev_seq_norm = LayerNorm(seq_full)
        self.prev_pair_norm = LayerNorm(pair_full)
        self.proj_prev_pos = Embedding(c.prev_pos.num_bins, pair_full)
        self.seqformer = Seqformer(c, seq_full, pair_full)

    def _rel_pos_ids(self, pos):
        mrf = self.config.max_relative_feature
        offset = pos[:, None, :] - pos[:, :, None]
        return torch.clamp(offset + mrf, 0, 2 * mrf) + 1

    def esm_layer_weights(self):
        return torch.softmax(self.esm_embed_weights.float(), dim=-1)

    def static_embeddings(self, batch):
        """Trajectory-invariant embedding terms."""
        residx = batch['residx']
        ab = self.antibody_len
        b = residx.shape[0]
        ag_seq_act = self.aa_proj(self.aa_proj_norm(
            self.proj_aa_type(batch['seq'][:, ab:])))
        ab_pair_act = self.proj_rel_pos(self._rel_pos_ids(residx[:, :ab]))
        ag_pair_act = self.proj_rel_pos(self._rel_pos_ids(residx[:, ab:]))
        static_seq = torch.cat(
            [ag_seq_act.new_zeros((b, ab, ag_seq_act.shape[-1])),
             ag_seq_act], dim=1)
        static_seq = static_seq + self.encode_residue_emb(batch)
        static_pair = pair_concat(ab_pair_act, ag_pair_act)
        static_pair = static_pair + self.encode_pair_emb(batch)
        return {'static_seq': static_seq, 'static_pair': static_pair}

    def forward(self, batch, static_acts, esm_fn=None):
        """`esm_fn(ab_aatype, heavy_len, light_len, layer_weights)` returns
        the weighted (B, L_ab, D) ESM2 embedding when `esm.enabled`."""
        c = self.config
        seq_t = batch['seq_t'].long()
        mask = batch['mask']
        ab = self.antibody_len
        ab_seq_act = self.proj_aa_type(seq_t[:, :ab])
        if c.esm.enabled:
            esm_act = esm_fn(seq_t[:, :ab], batch['heavy_len'],
                             batch['light_len'], self.esm_layer_weights())
            ab_seq_act = ab_seq_act + self.proj_esm_embed(
                self.esm_norm(esm_act))
        b, l = seq_t.shape
        seq_act = torch.cat(
            [ab_seq_act, ab_seq_act.new_zeros((b, l - ab,
                                               ab_seq_act.shape[-1]))], dim=1)
        seq_act = seq_act + static_acts['static_seq']
        t_embed = get_timestep_embedding(batch['t'], c.index_embed_size)
        seq_act = torch.cat(
            [seq_act, t_embed[:, None, :].expand(b, l, -1)], dim=-1)
        seq_act = seq_act + self.prev_seq_norm(batch['prev_seq'])
        pair_t = t_embed[:, None, None, :].expand(b, l, l, -1)
        pair_act = torch.cat([static_acts['static_pair'], pair_t, pair_t],
                             dim=-1)
        pair_act = pair_act + self.prev_pair_norm(batch['prev_pair'])
        pair_act = pair_act + self.proj_prev_pos.embedding[
            batch['prev_pos'].long()].float()
        return self.seqformer(seq_act, pair_act, mask)


