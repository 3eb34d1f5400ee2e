"""Seqformer trunk: single + pair representation evolution.

Counterpart of abx_tpu/models/seqformer.py.  In eval mode (the JAX
package's `deterministic=True`), on tensors that live on the card, and
with the registry flags on (their defaults), the recycled pair-input
assembly, the seq-attention pair bias, the seq attention, the
triangle-multiplication blocks around the contraction, both triangle
attentions and the pair transition run through the hand-written kernels
in `abx_tpu_torch/ops`; the opt-in flags route as in the JAX package (the
triangle contraction kernel under `ABX_PALLAS_TRIANGLE`, the
channel-major triangle multiplication under `ABX_TRIMULT_C_MAJOR` without
it, the gate-fold triangle multiplication under `ABX_TRIMULT_GATEFOLD`,
the triangle-attention epilogue kernel under `ABX_GATE_PROJ_KERNEL`
without the LN-fold).  Elsewhere the modules take the same plain path as
the JAX package off the TPU.

In train() mode (`deterministic=False`) no kernel route is taken, on the
card either: the kernels have no backward, as the Pallas kernels have
none.  The block then runs in the delta form with dropout after the seq
attention, both triangle multiplications and both triangle attentions,
drawn from the `generator` the caller passes, and every LayerNorm takes
the two-pass variance.  `SpatialDepthWiseInception` (`inp_kernels`) sits
between the projections and the attention or the contraction, and turns
the seq attention's, the triangle attention's and the triangle
multiplication's kernel routes off.
With `esm.enabled`, `EmbeddingAndSeqformer` adds the projected, learned
layer-weighted ESM2 embedding of the pass's noisy antibody sequence to the
antibody track (`models/esm.py`).
Under a profiler `EmbeddingAndSeqformer` is the span `abx.trunk`, its
input embeddings `abx.trunk.embed`, and each Seqformer module one of
`abx.trunk.seq_attn`, `.transition` (seq and pair), `.opm`, `.tri_mult`
(outgoing and incoming) and `.tri_attn` (starting and ending node), each
with its residual add.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.models.encoder import PairEmbedding, ResidueEmbedding
from abx_tpu_torch.models.modules import (MLP, Embedding, LayerNorm, Linear,
                                          fused_dense, get_timestep_embedding,
                                          layer_norm, shared_dropout)
from abx_tpu_torch.ops import registry
from abx_tpu_torch.ops.gate_proj import gate_proj_residual
from abx_tpu_torch.ops.pair_bias import pack_pair_bias, pair_bias_proj
from abx_tpu_torch.ops.recycle_embed import pack_recycle, recycle_embed
from abx_tpu_torch.ops.transition import fused_transition, pack_transition
from abx_tpu_torch.ops.tri_attention import (pack_projection,
                                             triangle_attention_packed)
from abx_tpu_torch.ops.tri_mult import (pack_gatefold, pack_post,
                                        pack_pre, tri_mult_post,
                                        tri_mult_post_gatefold, tri_mult_pre)
from abx_tpu_torch.ops.weight_cache import WeightCache
from abx_tpu_torch.ops.triangle import (triangle_multiply,
                                        triangle_multiply_c_major)
from abx_tpu_torch.utils.prof import annotate

BIG_NEG = -1e9


def _inp_kernels(cfg):
    return tuple(int(k) for k in (cfg.get('inp_kernels', ()) or ()))


def pair_concat(pair_1, pair_2):
    """Block-diagonal pair assembly."""
    b, l1, _, c = pair_1.shape
    l2 = pair_2.shape[1]
    top = torch.cat([pair_1, pair_1.new_zeros((b, l1, l2, c))], dim=2)
    bottom = torch.cat([pair_2.new_zeros((b, l2, l1, c)), pair_2], dim=2)
    return torch.cat([top, bottom], dim=1)


class SpatialDepthWiseInception(nn.Module):
    """Grouped depthwise 1-D convolution over the sequence axis.

    Input (B, N, L, D): N is split into len(kernels) equal groups; group 0
    (kernels[0] == 1) passes through, group i gets a depthwise convolution
    of odd width kernels[i] over L (zero padded, shape kept), with weights
    per D-channel shared by the group's N slots.  Params `conv{i}_weight`
    (k, D) and `conv{i}_bias` (D,), the flax names and layout, so the
    weight bridge maps them by name."""

    def __init__(self, head_dim: int, kernels):
        super().__init__()
        ks = tuple(int(k) for k in kernels)
        if len(ks) < 2 or ks[0] != 1:
            raise ValueError(f'inp_kernels {ks}: kernels[0] must be 1')
        for i, k in enumerate(ks[1:]):
            if k % 2 != 1:
                raise ValueError(f'inp kernel {k} must be odd')
            self.register_parameter(f'conv{i}_weight',
                                    nn.Parameter(torch.zeros(k, head_dim)))
            self.register_parameter(f'conv{i}_bias',
                                    nn.Parameter(torch.zeros(head_dim)))
        self.kernels = ks

    def reset(self, generator) -> None:
        """torch Conv1d(D, D, k, groups=D)'s init: U(+-1/sqrt(k)), bias 0."""
        with torch.no_grad():
            for i, k in enumerate(self.kernels[1:]):
                w = getattr(self, f'conv{i}_weight')
                lim = k ** -0.5
                w.copy_(torch.rand(w.shape, generator=generator) * 2 * lim
                        - lim)
                getattr(self, f'conv{i}_bias').zero_()

    def forward(self, x):
        n, l = x.shape[1], x.shape[2]
        if n % len(self.kernels):
            raise ValueError(f'SDWI: {n} rows do not split into '
                             f'{len(self.kernels)} groups')
        g = n // len(self.kernels)
        outs = [x[:, :g]]
        for i, k in enumerate(self.kernels[1:]):
            w = getattr(self, f'conv{i}_weight').to(x.dtype)
            xg = x[:, g * (i + 1):g * (i + 2)]
            xp = F.pad(xg, (0, 0, k // 2, k // 2))
            y = getattr(self, f'conv{i}_bias').to(x.dtype)
            for t in range(k):
                y = y + xp[:, :, t:t + l] * w[t]
            outs.append(y)
        return torch.cat(outs, dim=1)


def _sdwi_heads(sdwi, t):
    """SDWI on a heads-minor (B, ..., L, h, d) tensor, its leading (rows,
    heads) axes flattened rows-major, as the reference's
    `rearrange(t, 'b s h l d -> b (s h) l d')`."""
    shape = t.shape
    b, l, h, d = shape[0], shape[-3], shape[-2], shape[-1]
    x = t.reshape(b, -1, l, h, d)
    rows = x.shape[1]
    x = x.transpose(2, 3).reshape(b, rows * h, l, d)
    x = sdwi(x).reshape(b, rows, h, l, d).transpose(2, 3)
    return x.reshape(shape)


def _sdwi_pair(sdwi, t, num_head: int, per_row: bool):
    """SDWI on a pair-track projection (B, I, J, h*d) in the reference's
    orientation: per_row convolves over j with groups over (i, h);
    per_column over i with groups over (j, h)."""
    b, i, j, hd = t.shape
    d = hd // num_head
    x = t.reshape(b, i, j, num_head, d)
    if per_row:
        x = x.transpose(2, 3).reshape(b, i * num_head, j, d)
        x = sdwi(x).reshape(b, i, num_head, j, d).transpose(2, 3)
    else:
        x = x.permute(0, 2, 3, 1, 4).reshape(b, j * num_head, i, d)
        x = sdwi(x).reshape(b, j, num_head, i, d).permute(0, 3, 1, 2, 4)
    return x.reshape(b, i, j, hd)


class GatedAttention(nn.Module):
    """Multi-head self-attention with pair bias, gating and key mask, on
    (B, S, Q, C) with a broadcast rows axis S; `inp_kernels` convolves
    q, k and v (SDWI modules `inp_q`, `inp_k`, `inp_v`) before the
    attention."""

    def __init__(self, c_in: int, key_dim: int, value_dim: int,
                 output_dim: int, num_head: int, gating: bool = True,
                 split_first: bool = True, dtype=torch.float32,
                 inp_kernels=()):
        super().__init__()
        self.num_head = num_head
        self.key_dim, self.value_dim = key_dim, value_dim
        self.gating = gating
        self.split_first = split_first
        self.dtype = dtype
        if split_first:
            self.proj_q = Linear(c_in, key_dim, 'attn', bias=False,
                                 dtype=dtype)
            self.proj_k = Linear(c_in, key_dim, 'attn', bias=False,
                                 dtype=dtype)
            self.proj_v = Linear(c_in, value_dim, 'attn', bias=False,
                                 dtype=dtype)
        else:
            self.proj_in = Linear(c_in, key_dim * 3, 'attn', bias=False,
                                  dtype=dtype)
        if gating:
            self.gate = Linear(c_in, value_dim, 'gate', dtype=dtype)
        self.proj_out = Linear(value_dim, output_dim, 'final', dtype=dtype)
        if inp_kernels:
            self.inp_q = SpatialDepthWiseInception(key_dim // num_head,
                                                   inp_kernels)
            self.inp_k = SpatialDepthWiseInception(key_dim // num_head,
                                                   inp_kernels)
            self.inp_v = SpatialDepthWiseInception(value_dim // num_head,
                                                   inp_kernels)
        self.inp = bool(inp_kernels)
        # The kernel route's packed weights: with the LN-fold, and without.
        self._packs = {True: WeightCache(), False: WeightCache()}

    def _qkv_weights(self):
        """(H*D, C) q/k/v weights.  The seq track's proj_in has per-head
        [q|k|v] row blocks (reference layout); regroup them into
        [q_all | k_all | v_all] for the packed kernel."""
        if self.split_first:
            return self.proj_q.weight, self.proj_k.weight, self.proj_v.weight
        h = self.num_head
        kd = self.key_dim // h
        w3 = self.proj_in.weight.reshape(h, 3, kd, -1)
        return tuple(w3[:, i].reshape(h * kd, -1) for i in range(3))

    def _packed(self, dtype, ln=None):
        """The fused projection (and with `ln`, the gate and the out-proj)
        packed for the kernels, from the cache (rebuilt when a weight
        changes)."""
        fold = ln is not None
        heads = ([self.proj_q, self.proj_k, self.proj_v] if self.split_first
                 else [self.proj_in])
        sources = [m.weight for m in heads]
        if fold:
            sources += [*ln, self.gate.weight, self.gate.bias,
                        self.proj_out.weight, self.proj_out.bias]

        def build():
            kw = {}
            if fold:
                kw = dict(ln=ln, gate=(self.gate.weight, self.gate.bias),
                          out_proj=(self.proj_out.weight, self.proj_out.bias))
            return pack_projection(*self._qkv_weights(),
                                   self.key_dim // self.num_head, dtype,
                                   **kw)
        return self._packs[fold].get(sources, dtype, build)

    def forward(self, q_data, bias, k_mask, kernel: bool = False,
                residual=None, ln=None):
        """q_data (B, S, Q, C); bias (B, H, Q, K); k_mask (B, 1, K).

        `kernel` routes through the packed attention wrapper; with `ln`
        (LayerNorm params; needs gating and `residual`) q_data is RAW and
        the LayerNorm, the gate, the out-proj and the residual run inside
        it.  Without `ln`, the gate, the out-proj and the residual run in
        the `gate_proj_residual` kernel under `ABX_GATE_PROJ_KERNEL`."""
        h = self.num_head
        dt = self.dtype
        if kernel:
            wq, wk, wv = self._qkv_weights()
            mask = k_mask[:, 0]
            packed = self._packed(q_data.dtype, ln)
            if ln is not None:
                return triangle_attention_packed(
                    q_data, wq, wk, wv, bias, mask, ln=ln,
                    gate=(self.gate.weight, self.gate.bias),
                    out_proj=(self.proj_out.weight, self.proj_out.bias),
                    residual=residual, packed=packed)
            out = triangle_attention_packed(q_data, wq, wk, wv, bias, mask,
                                            packed=packed)
            if (self.gating and residual is not None
                    and registry.use_gate_proj_kernel()):
                return gate_proj_residual(out, self.gate(q_data),
                                          self.proj_out.weight,
                                          self.proj_out.bias, residual)
            if self.gating:
                out = out * torch.sigmoid(self.gate(q_data))
            out = self.proj_out(out)
            return out if residual is None else residual + out

        key_dim = self.key_dim // h
        value_dim = self.value_dim // h
        gate_pre = None
        if self.split_first:
            branches = [self.proj_q, self.proj_k, self.proj_v]
            if self.gating:
                q, k, v, gate_pre = fused_dense(q_data, branches + [self.gate],
                                                dt)
            else:
                q, k, v = fused_dense(q_data, branches, dt)
            q = q.reshape(q.shape[:-1] + (h, key_dim))
            k = k.reshape(k.shape[:-1] + (h, key_dim))
            v = v.reshape(v.shape[:-1] + (h, value_dim))
        else:
            if self.gating:
                qkv, gate_pre = fused_dense(q_data, [self.proj_in, self.gate],
                                            dt)
            else:
                (qkv,) = fused_dense(q_data, [self.proj_in], dt)
            qkv = qkv.reshape(qkv.shape[:-1] + (h, 3 * key_dim))
            q, k, v = torch.split(qkv, key_dim, dim=-1)
        if self.inp:
            q = _sdwi_heads(self.inp_q, q)
            k = _sdwi_heads(self.inp_k, k)
            v = _sdwi_heads(self.inp_v, v)
        q = q * (key_dim ** -0.5)
        logits = torch.einsum('...qhd,...khd->...hqk', q, k)
        logits = logits + bias[:, None].to(logits.dtype)
        neg = (1.0 - k_mask[:, :, None, None, :].float()) * BIG_NEG
        logits = logits + neg.to(logits.dtype)
        weights = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.einsum('...hqk,...khd->...qhd', weights, v)
        out = out.reshape(out.shape[:-2] + (self.value_dim,))
        if self.gating:
            out = out * torch.sigmoid(gate_pre)
        out = self.proj_out(out)
        return out if residual is None else residual + out


def _bias_packed(cache, norm, proj, dtype):
    """pair_bias_proj's weights (LayerNorm `norm`, projection `proj`) for
    the kernels, from `cache` (rebuilt when one of them changes)."""
    params = (norm.scale, norm.bias, proj.weight)
    return cache.get(list(params), dtype,
                     lambda: pack_pair_bias(*params, dtype))


class SeqAttentionWithPairBias(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int, dtype=torch.float32):
        super().__init__()
        self.inp = bool(_inp_kernels(config))
        self.dtype = dtype
        self.seq_norm = LayerNorm(seq_c, dtype=dtype)
        self.pair_norm = LayerNorm(pair_c, dtype=dtype)
        self.proj_pair = Linear(pair_c, config.num_head, 'linear', bias=False,
                                dtype=dtype)
        self.attn = GatedAttention(seq_c, seq_c, seq_c, seq_c,
                                   config.num_head, split_first=False,
                                   dtype=dtype,
                                   inp_kernels=_inp_kernels(config))
        self._bias_pack = WeightCache()   # pair_bias_proj's weights

    def forward(self, seq_act, pair_act, mask, residual: bool = False):
        """`residual=True` returns seq_act + attention(seq_act)."""
        dt = self.dtype
        res_in = seq_act
        if (registry.kernel_route(self, pair_act)
                and registry.use_fused_pair_bias()):
            bias = pair_bias_proj(
                pair_act, self.pair_norm.scale, self.pair_norm.bias,
                self.proj_pair.weight, packed=_bias_packed(
                    self._bias_pack, self.pair_norm, self.proj_pair,
                    pair_act.dtype))
        else:
            ln = self.pair_norm(pair_act)
            bias = F.linear(ln, self.proj_pair.weight.to(dt))
            bias = bias.permute(0, 3, 1, 2)
        if (residual and not self.inp
                and registry.kernel_route(self, seq_act)
                and registry.use_packed_seq_attn()):
            out = self.attn(seq_act[:, None], bias, mask[:, None],
                            kernel=True,
                            ln=(self.seq_norm.scale, self.seq_norm.bias),
                            residual=res_in[:, None])
            return out[:, 0]
        out = self.attn(self.seq_norm(seq_act)[:, None], bias,
                        mask[:, None])[:, 0]
        return res_in + out if residual else out


class Transition(nn.Module):
    def __init__(self, config, num_in: int, dtype=torch.float32):
        super().__init__()
        n_mid = num_in * config.num_intermediate_factor
        self.dtype = dtype
        self.norm = LayerNorm(num_in, dtype=dtype)
        self.in_proj = Linear(num_in, n_mid, 'linear', dtype=dtype)
        self.out_proj = Linear(n_mid, num_in, 'final', dtype=dtype)
        self._pack = WeightCache()   # the fused kernel's weights

    def forward(self, act, residual: bool = False):
        """LN -> C*factor -> relu -> C [+ act when residual]; the 4-D pair
        track goes through the fused kernel on the card."""
        if (residual and act.dim() == 4 and registry.kernel_route(self, act)
                and registry.use_fused_transition()):
            params = (self.norm.scale, self.norm.bias, self.in_proj.weight,
                      self.in_proj.bias, self.out_proj.weight,
                      self.out_proj.bias)
            packed = self._pack.get(
                list(params), act.dtype,
                lambda: pack_transition(*params, act.dtype))
            return fused_transition(act, *params, packed=packed)
        x = torch.relu(self.in_proj(self.norm(act)))
        out = self.out_proj(x)
        return act + out if residual else out


class OuterProductMean(nn.Module):
    """ESMFold-style outer product + difference."""

    def __init__(self, config, num_in: int, num_out: int,
                 dtype=torch.float32):
        super().__init__()
        noc = config.num_outer_channel
        self.dtype = dtype
        self.norm = LayerNorm(num_in, dtype=dtype)
        self.left_proj = Linear(num_in, noc, 'linear', dtype=dtype)
        self.right_proj = Linear(num_in, noc, 'linear', dtype=dtype)
        self.out_proj = Linear(2 * noc, num_out, 'final', dtype=dtype)

    def forward(self, act, mask):
        mask_col = mask[..., None]
        act = self.norm(act)
        left, right = fused_dense(act, [self.left_proj, self.right_proj],
                                  self.dtype)
        left = mask_col * left
        right = mask_col * right
        prod = left[:, None, :, :] * right[:, :, None, :]
        diff = left[:, None, :, :] - right[:, :, None, :]
        return self.out_proj(torch.cat([prod, diff], dim=-1))


class TriangleMultiplication(nn.Module):
    """Triangle multiplication; on the card (residual, gated) the blocks
    around the contraction run as the tri_mult pre/post kernels: in the
    channel-major layout around a batched matrix product under
    `ABX_TRIMULT_C_MAJOR` (without `ABX_PALLAS_TRIANGLE`), as pre without
    the final gate and the gate-fold post under `ABX_TRIMULT_GATEFOLD`,
    and in the natural layout otherwise."""

    def __init__(self, config, num_in: int, dtype=torch.float32):
        super().__init__()
        nc = config.num_intermediate_channel
        inp = _inp_kernels(config)
        self.per_row = config.orientation == 'per_row'
        self.gating = config.gating
        self.inp = bool(inp)
        if inp:
            # The reference's left/right inception over (num_head) groups
            # of the nc channels.
            self.num_head = config.num_head
            self.inp_left = SpatialDepthWiseInception(nc // config.num_head,
                                                      inp)
            self.inp_right = SpatialDepthWiseInception(nc // config.num_head,
                                                       inp)
        self.dtype = dtype
        self.norm = LayerNorm(num_in, dtype=dtype)
        self.left_proj = Linear(num_in, nc, 'linear', dtype=dtype)
        self.right_proj = Linear(num_in, nc, 'linear', dtype=dtype)
        if self.gating:
            self.left_gate = Linear(num_in, nc, 'gate', dtype=dtype)
            self.right_gate = Linear(num_in, nc, 'gate', dtype=dtype)
            self.final_gate = Linear(num_in, num_in, 'gate', dtype=dtype)
        self.final_norm = LayerNorm(nc, dtype=dtype)
        self.proj_out = Linear(nc, num_in, 'final', dtype=dtype)
        # The pre kernel's packed weights: with the final gate, and without;
        # the post's; the gate-fold post's.
        self._packs = {True: WeightCache(), False: WeightCache()}
        self._post_pack = WeightCache()
        self._fold_pack = WeightCache()

    def _pre_packed(self, dtype, emit_fgate: bool):
        """The pre block's projections packed for the kernel, from the cache
        (rebuilt when a weight changes)."""
        branches = [self.left_proj, self.right_proj, self.left_gate,
                    self.right_gate] + ([self.final_gate] if emit_fgate
                                        else [])
        weights = [m.weight for m in branches]
        biases = [m.bias for m in branches]
        ln = [self.norm.scale, self.norm.bias]
        return self._packs[emit_fgate].get(
            weights + biases + ln, dtype,
            lambda: pack_pre(weights, biases, *ln, dtype))

    def _post_params(self):
        """The post's parameters, in its wrapper's order."""
        return (self.final_norm.scale, self.final_norm.bias,
                self.proj_out.weight, self.proj_out.bias)

    def _post_packed(self, dtype):
        """The post's weights packed for the kernels, from the cache
        (rebuilt when one of them changes)."""
        params = self._post_params()
        return self._post_pack.get(list(params), dtype,
                                   lambda: pack_post(*params, dtype))

    def _fold_params(self):
        """The gate-fold post's parameters, in its wrapper's order."""
        return (self.final_norm.scale, self.final_norm.bias,
                self.proj_out.weight, self.proj_out.bias, self.norm.scale,
                self.norm.bias, self.final_gate.weight, self.final_gate.bias)

    def _fold_packed(self, dtype):
        """The gate-fold post's weights packed for the kernel, from the
        cache (rebuilt when one of them changes)."""
        params = self._fold_params()
        return self._fold_pack.get(list(params), dtype,
                                   lambda: pack_gatefold(*params, dtype))

    def forward(self, act, mask, residual: bool = False):
        dt = self.dtype
        use_pallas = registry.use_pallas_triangle() and not self.training
        if (residual and self.gating and act.dim() == 4 and not self.inp
                and registry.kernel_route(self, act)
                and registry.use_fused_trimult()):
            # Channel-major is checked first, as in the JAX package: no
            # layout copies around the contraction's matrix product.
            c_major = registry.use_trimult_c_major() and not use_pallas
            if registry.use_trimult_gatefold() and not c_major:
                pk = self._pre_packed(act.dtype, False)
                left, right = tri_mult_pre(
                    act, self.norm.scale, self.norm.bias, pk.w, pk.wb, mask,
                    emit_fgate=False, packed=pk)
                out = triangle_multiply(left, right, per_row=self.per_row,
                                        use_pallas=use_pallas)
                return tri_mult_post_gatefold(
                    out, *self._fold_params(), act,
                    packed=self._fold_packed(act.dtype))
            pk = self._pre_packed(act.dtype, True)
            left, right, fg = tri_mult_pre(
                act, self.norm.scale, self.norm.bias, pk.w, pk.wb, mask,
                c_major=c_major, packed=pk)
            if c_major:
                out = triangle_multiply_c_major(left, right,
                                                per_row=self.per_row)
            else:
                out = triangle_multiply(left, right, per_row=self.per_row,
                                        use_pallas=use_pallas)
            return tri_mult_post(out, *self._post_params(), fg, act,
                                 y_c_major=c_major,
                                 packed=self._post_packed(act.dtype))
        pair_mask = (mask[:, :, None, None] * mask[:, None, :, None]).to(dt)
        x = self.norm(act)
        branches = [self.left_proj, self.right_proj]
        if self.gating:
            left, right, lg, rg, fg = fused_dense(
                x, branches + [self.left_gate, self.right_gate,
                               self.final_gate], dt)
        else:
            left, right = fused_dense(x, branches, dt)
        if self.inp:
            # Reference order: projection -> inception -> mask and gate
            # (elementwise, so gating after the convolution is the same).
            left = _sdwi_pair(self.inp_left, left, self.num_head,
                              self.per_row)
            right = _sdwi_pair(self.inp_right, right, self.num_head,
                               self.per_row)
        if self.gating:
            left = left * torch.sigmoid(lg)
            right = right * torch.sigmoid(rg)
        left = left * pair_mask
        right = right * pair_mask
        out = triangle_multiply(left, right, per_row=self.per_row,
                                use_pallas=use_pallas)
        out = self.proj_out(self.final_norm(out))
        if self.gating:
            out = out * torch.sigmoid(fg)
        return act + out if residual else out


class TriangleAttention(nn.Module):
    def __init__(self, config, c_in: int, dtype=torch.float32):
        super().__init__()
        self.inp = bool(_inp_kernels(config))
        self.per_column = config.orientation == 'per_column'
        self.gating = config.gating
        self.dtype = dtype
        self.norm = LayerNorm(c_in, dtype=dtype)
        self.proj_pair = Linear(c_in, config.num_head, 'linear', bias=False,
                                dtype=dtype)
        self.attn = GatedAttention(c_in, c_in, c_in, c_in, config.num_head,
                                   gating=config.gating, dtype=dtype,
                                   inp_kernels=_inp_kernels(config))
        self._bias_pack = WeightCache()   # pair_bias_proj's weights

    def forward(self, pair_act, seq_mask, residual: bool = False):
        """`residual=True` adds the input in this module's epilogue (inside
        the packed kernel on the card)."""
        kernel = (not self.inp and registry.kernel_route(self, pair_act)
                  and registry.use_fused_tri_attention())
        x = pair_act
        if self.per_column:
            x = x.transpose(1, 2).contiguous()
        if (kernel and residual and self.gating
                and registry.use_tri_attn_ln_fold()):
            # LN-fold path: the raw (oriented) tensor goes in; the bias is
            # computed on that same oriented tensor.
            ln = (self.norm.scale, self.norm.bias)
            bias = pair_bias_proj(
                x, ln[0], ln[1], self.proj_pair.weight,
                packed=_bias_packed(self._bias_pack, self.norm,
                                    self.proj_pair, x.dtype))
            out = self.attn(x, bias, seq_mask[:, None], kernel=True,
                            residual=x, ln=ln)
        else:
            res_in = x if residual else None
            xn = self.norm(x)
            bias = self.proj_pair(xn).permute(0, 3, 1, 2)
            out = self.attn(xn, bias, seq_mask[:, None], kernel=kernel,
                            residual=res_in)
        if self.per_column:
            out = out.transpose(1, 2).contiguous()
        return out


class SeqformerIteration(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int, dtype=torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.seq_attn = SeqAttentionWithPairBias(
            c.seq_attention_with_pair_bias, seq_c, pair_c, dtype)
        self.seq_transition = Transition(c.seq_transition, seq_c, dtype)
        self.outer_product_mean = OuterProductMean(c.outer_product_mean,
                                                   seq_c, pair_c, dtype)
        self.tri_mul_out = TriangleMultiplication(
            c.triangle_multiplication_outgoing, pair_c, dtype)
        self.tri_mul_in = TriangleMultiplication(
            c.triangle_multiplication_incoming, pair_c, dtype)
        self.tri_attn_start = TriangleAttention(
            c.triangle_attention_starting_node, pair_c, dtype)
        self.tri_attn_end = TriangleAttention(
            c.triangle_attention_ending_node, pair_c, dtype)
        self.pair_transition = Transition(c.pair_transition, pair_c, dtype)

    def _dropout(self, value, cfg, generator):
        """The reference's `apply_dropout`: shared along the rows
        (per_row) or the columns (per_column) where `shared_dropout`."""
        dim = None
        if cfg.shared_dropout:
            dim = 1 if cfg.orientation == 'per_row' else 2
        return shared_dropout(value, cfg.dropout_rate, generator, dim)

    def forward(self, seq_act, pair_act, seq_mask, generator=None):
        """In eval mode the residual adds fold into the modules' kernel
        epilogues; in train() mode each residual branch is a delta with
        dropout drawn from `generator`."""
        c = self.config
        with annotate('abx.trunk.seq_attn'):
            if not self.training:
                seq_act = self.seq_attn(seq_act, pair_act, seq_mask,
                                        residual=True)
            else:
                seq_act = seq_act + self._dropout(
                    self.seq_attn(seq_act, pair_act, seq_mask),
                    c.seq_attention_with_pair_bias, generator)
        with annotate('abx.trunk.transition'):
            seq_act = seq_act + self.seq_transition(seq_act)
        with annotate('abx.trunk.opm'):
            pair_act = pair_act + self.outer_product_mean(seq_act, seq_mask)
        blocks = (('abx.trunk.tri_mult', self.tri_mul_out,
                   c.triangle_multiplication_outgoing),
                  ('abx.trunk.tri_mult', self.tri_mul_in,
                   c.triangle_multiplication_incoming),
                  ('abx.trunk.tri_attn', self.tri_attn_start,
                   c.triangle_attention_starting_node),
                  ('abx.trunk.tri_attn', self.tri_attn_end,
                   c.triangle_attention_ending_node))
        for span, module, cfg in blocks:
            with annotate(span):
                if not self.training:
                    pair_act = module(pair_act, seq_mask, residual=True)
                else:
                    pair_act = pair_act + self._dropout(
                        module(pair_act, seq_mask), cfg, generator)
        with annotate('abx.trunk.transition'):
            return seq_act, self.pair_transition(pair_act, residual=True)


class Seqformer(nn.Module):
    def __init__(self, config, seq_c: int, pair_c: int, dtype=torch.float32):
        super().__init__()
        self.num_block = config.seqformer_num_block
        for i in range(self.num_block):
            self.add_module(f'block_{i}', SeqformerIteration(
                config.seqformer, seq_c, pair_c, dtype))

    def forward(self, seq_act, pair_act, mask, generator=None):
        for i in range(self.num_block):
            seq_act, pair_act = getattr(self, f'block_{i}')(
                seq_act, pair_act, mask, generator)
        return seq_act, pair_act


class EmbeddingAndSeqformer(nn.Module):
    """Input embedding + trunk.  The antibody block occupies positions
    [0, antibody_len) and the antigen block [antibody_len, L).
    `static_embeddings` holds every trajectory-invariant term, so the
    sampler computes it once per trajectory."""

    def __init__(self, config, antibody_len: int, dtype=torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.antibody_len = antibody_len
        self.dtype = dtype
        num_token = rc.restype_num + 3
        sc, pc, ie = c.seq_channel, c.pair_channel, c.index_embed_size
        self.proj_aa_type = Embedding(num_token, sc,
                                      padding_idx=rc.unk_restype_index,
                                      dtype=dtype)
        self.proj_rel_pos = Embedding(c.max_relative_feature * 2 + 2, pc,
                                      dtype=dtype)
        if c.esm.enabled:
            # Learned layer weights (zeros: a uniform softmax at init).
            self.esm_embed_weights = nn.Parameter(
                torch.zeros(c.esm.num_layers + 1))
            self.esm_norm = LayerNorm(c.esm.embed_channel, dtype=dtype)
            self.proj_esm_embed = MLP(c.esm.embed_channel, (sc, sc),
                                      ('linear', 'linear'), dtype=dtype)
        self.aa_proj_norm = LayerNorm(sc, dtype=dtype)
        self.aa_proj = MLP(sc, (sc, sc), ('linear', 'linear'), dtype=dtype)
        self.encode_residue_emb = ResidueEmbedding(sc, dtype=dtype)
        self.encode_pair_emb = PairEmbedding(
            pc, dgram_num_bins=c.prev_pos.num_bins,
            dgram_min_bin=c.prev_pos.min_bin,
            dgram_max_bin=c.prev_pos.max_bin, dtype=dtype)
        seq_full, pair_full = sc + ie, pc + 2 * ie
        if c.recycle_features:
            self.prev_seq_norm = LayerNorm(seq_full, dtype=dtype)
            self.prev_pair_norm = LayerNorm(pair_full, dtype=dtype)
        if c.recycle_pos:
            self.proj_prev_pos = Embedding(c.prev_pos.num_bins, pair_full,
                                           dtype=dtype)
        self._recycle_pack = WeightCache()   # recycle_embed's f32 params
        self.seqformer = Seqformer(c, seq_full, pair_full, dtype)

    def _rel_pos_ids(self, pos):
        mrf = self.config.max_relative_feature
        offset = pos[:, None, :] - pos[:, :, None]
        return torch.clamp(offset + mrf, 0, 2 * mrf) + 1

    def _recycled_pair(self, static_pair, t_embed, batch):
        """The recycled pair input in one pass (concat + LN + bin embed),
        the time embedding on both index-embed blocks, with the kernel's
        f32 params from the cache (rebuilt when one of them changes)."""
        params = (self.prev_pair_norm.scale, self.prev_pair_norm.bias,
                  self.proj_prev_pos.embedding)
        packed = self._recycle_pack.get(list(params), torch.float32,
                                        lambda: pack_recycle(*params))
        return recycle_embed(static_pair, t_embed, batch['prev_pair'],
                             *params, batch['prev_pos'], packed=packed)

    def esm_layer_weights(self):
        """Softmax of the learned weights over the ESM layer
        representations."""
        return torch.softmax(self.esm_embed_weights, dim=-1)

    def static_embeddings(self, batch):
        """Trajectory-invariant embedding terms (they read seq_t only at
        fixed positions, which the reverse step never changes)."""
        residx = batch['residx']
        ab = self.antibody_len
        b = residx.shape[0]
        ag_embed = self.aa_proj_norm(self.proj_aa_type(batch['seq'][:, ab:]))
        ag_seq_act = self.aa_proj(ag_embed)
        ab_pair_act = self.proj_rel_pos(self._rel_pos_ids(residx[:, :ab]))
        ag_pair_act = self.proj_rel_pos(self._rel_pos_ids(residx[:, ab:]))
        static_seq = torch.cat(
            [ag_seq_act.new_zeros((b, ab, ag_seq_act.shape[-1])),
             ag_seq_act], dim=1)
        static_seq = static_seq + self.encode_residue_emb(batch)
        static_pair = pair_concat(ab_pair_act, ag_pair_act)
        static_pair = static_pair + self.encode_pair_emb(batch)
        return {'static_seq': static_seq, 'static_pair': static_pair}

    def forward(self, batch, static_acts=None, esm_fn=None, generator=None):
        """`esm_fn(ab_aatype, heavy_len, light_len, layer_weights)` (an
        `AntibodyESM`) is required when `esm.enabled` and the batch holds no
        `esm_weighted`: it runs on this pass's noisy antibody sequence and
        returns the weighted (B, L_ab, D) embedding.  `generator` draws the
        trunk's dropout in train() mode."""
        with annotate('abx.trunk'):
            with annotate('abx.trunk.embed'):
                seq_act, pair_act = self._embed(batch, static_acts, esm_fn)
            return self.seqformer(seq_act, pair_act, batch['mask'],
                                  generator)

    def _embed(self, batch, static_acts, esm_fn):
        """The trunk's (seq, pair) input: the sequence, ESM2, time and
        recycling embeddings on the trajectory's static terms."""
        c = self.config
        dt = self.dtype
        seq_t = batch['seq_t'].long()
        ab = self.antibody_len
        if static_acts is None:
            static_acts = self.static_embeddings(batch)
        ab_seq_act = self.proj_aa_type(seq_t[:, :ab])
        if c.esm.enabled:
            if 'esm_weighted' in batch:
                # The caller's weighted (B, L_ab, D) embedding (the
                # sampler's esm_reuse_recycles: one ESM pass a step, shared
                # by the recycle passes), cast as the esm_fn output is, so
                # a single pass is bitwise the same either way.
                esm_act = batch['esm_weighted'].to(dt)
            elif esm_fn is None:
                raise ValueError('esm.enabled needs an esm_fn')
            else:
                esm_act = esm_fn(seq_t[:, :ab], batch['heavy_len'],
                                 batch['light_len'],
                                 self.esm_layer_weights()).to(dt)
            ab_seq_act = ab_seq_act + self.proj_esm_embed(
                self.esm_norm(esm_act))
        b, l = seq_t.shape
        seq_act = torch.cat(
            [ab_seq_act, ab_seq_act.new_zeros((b, l - ab,
                                               ab_seq_act.shape[-1]))], dim=1)
        seq_act = seq_act + static_acts['static_seq']
        t_embed = get_timestep_embedding(batch['t'],
                                         c.index_embed_size).to(dt)
        seq_act = torch.cat(
            [seq_act, t_embed[:, None, :].expand(b, l, -1)], dim=-1)
        if c.recycle_features and 'prev_seq' in batch:
            seq_act = seq_act + self.prev_seq_norm(batch['prev_seq'])
        static_pair = static_acts['static_pair']
        if (c.recycle_features and c.recycle_pos and 'prev_pair' in batch
                and 'prev_pos' in batch
                and registry.kernel_route(self, static_pair)
                and registry.use_fused_recycle_embed()):
            return seq_act, self._recycled_pair(static_pair, t_embed, batch)
        pair_t = t_embed[:, None, None, :].expand(b, l, l, -1)
        pair_act = torch.cat([static_pair, pair_t, pair_t], dim=-1)
        if c.recycle_features and 'prev_pair' in batch:
            pair_act = pair_act + layer_norm(
                batch['prev_pair'], self.prev_pair_norm.scale,
                self.prev_pair_norm.bias, dtype=dt, two_pass=self.training)
        if c.recycle_pos and 'prev_pos' in batch:
            pair_act = pair_act + self.proj_prev_pos.embedding[
                batch['prev_pos'].long()].to(dt)
        return seq_act, pair_act
