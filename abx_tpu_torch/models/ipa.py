"""Invariant Point Attention + the diffusion structure module (IpaScore).

Counterpart of abx_tpu/models/ipa.py: 8 shared-weight IPA layers over the
noisy rigids, per-layer affine updates with fixed-residue snap-back, and
rotation/translation scores through the diffuser's closed forms.  The point
attention runs in f32.  In eval mode on the card, with ABX_FUSED_IPA_ATTN
on, the logits, softmax and the three attends run in the hand-written
kernel (`ops/ipa_attention.py`); it masks keys only, the plain path also
masks query rows.  With it off and ABX_IPA_ATTEND on, the attend over the
pair track runs in its own kernel (`ops/ipa_attend.py`).  In train() mode
both kernels are off, dropout follows the IPA and the transition, the
rotations are detached between layers (the reference's no-grad rots;
`delta_quat` keeps its gradient), and the output carries the per-layer
frames (`traj`) that the FAPE loss reads.  Under a profiler `IpaScore` is
the span `abx.ipa` and each IPA call `abx.ipa.attn`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from abx_tpu_torch.geometry import quat as quat_ops
from abx_tpu_torch.geometry.rigid import Rigid
from abx_tpu_torch.models.modules import (LayerNorm, Linear, fused_dense,
                                          shared_dropout)
from abx_tpu_torch.ops import registry
from abx_tpu_torch.ops.ipa_attend import ipa_pair_attend
from abx_tpu_torch.ops.ipa_attention import ipa_attention
from abx_tpu_torch.utils.prof import annotated

BIG_NEG = -1e9


class InvariantPointAttention(nn.Module):
    def __init__(self, config, c_in: int, c_pair: int, dtype=torch.float32,
                 dist_epsilon: float = 1e-8):
        super().__init__()
        c = config
        h = c.num_head
        self.config = c
        self.dtype = dtype
        self.dist_epsilon = dist_epsilon
        nsq, npq, nsv, npv = (c.num_scalar_qk, c.num_point_qk,
                              c.num_scalar_v, c.num_point_v)
        self.proj_q_scalar = Linear(c_in, h * nsq, 'attn', dtype=dtype)
        self.proj_kv_scalar = Linear(c_in, h * (nsv + nsq), 'attn',
                                     dtype=dtype)
        self.proj_q_point_local = Linear(c_in, 3 * h * npq, 'attn',
                                         dtype=dtype)
        self.proj_kv_point_local = Linear(c_in, 3 * h * (npv + npq), 'attn',
                                          dtype=dtype)
        self.trainable_point_weights = nn.Parameter(torch.zeros(h))
        self.proj_pair = Linear(c_pair, h, 'attn', dtype=dtype)
        final_in = h * nsv + 3 * h * npv + h * npv + h * c_pair
        self.final_proj = Linear(final_in, c.num_channel, 'final',
                                 dtype=dtype)

    def reset(self, generator) -> None:
        with torch.no_grad():
            self.trainable_point_weights.fill_(float(np.log(np.exp(1.0)
                                                            - 1.0)))

    def compute_pair_bias(self, inputs_2d):
        """(B, L, L, C) -> scaled (B, H, L, L) attention bias (layer
        invariant: the caller computes it once for all layers)."""
        return np.sqrt(1.0 / 3) * self.proj_pair(inputs_2d).permute(0, 3, 1, 2)

    @annotated('abx.ipa.attn')
    def forward(self, inputs_1d, inputs_2d, mask, rigids: Rigid, pair_bias):
        c = self.config
        h = c.num_head
        nsq, npq, nsv, npv = (c.num_scalar_qk, c.num_point_qk,
                              c.num_scalar_v, c.num_point_v)
        dt = self.dtype
        scalar_weights = np.sqrt(1.0 / (3 * max(nsq, 1) * 1.0))
        point_weights = np.sqrt(1.0 / (3 * max(npq, 1) * 9.0 / 2))
        b, l, _ = inputs_1d.shape

        q_scalar, kv_scalar, q_point_local, kv_point_local = fused_dense(
            inputs_1d, [self.proj_q_scalar, self.proj_kv_scalar,
                        self.proj_q_point_local, self.proj_kv_point_local],
            dt)
        q_scalar = q_scalar.reshape(b, l, h, nsq)
        kv_scalar = kv_scalar.reshape(b, l, h, nsv + nsq)
        k_scalar, v_scalar = kv_scalar[..., :nsq], kv_scalar[..., nsq:]
        q_point_local = q_point_local.float().reshape(
            b, l, 3, h * npq).transpose(2, 3)
        kv_point_local = kv_point_local.float().reshape(
            b, l, 3, h * (npv + npq)).transpose(2, 3)
        q_point = rigids.apply(q_point_local).reshape(b, l, h, npq, 3)
        kv_point = rigids.apply(kv_point_local).reshape(b, l, h, npv + npq, 3)
        k_point, v_point = kv_point[..., :npq, :], kv_point[..., npq:, :]
        # Centre before the |q|^2 + |k|^2 - 2 q.k expansion (cancellation).
        center = k_point.mean(dim=(1, 3), keepdim=True)
        q_point = q_point - center
        k_point = k_point - center
        pw = -0.5 * point_weights * F.softplus(self.trainable_point_weights)

        kernels = registry.kernel_route(self, inputs_1d)
        if kernels and registry.use_fused_ipa_attention():
            result_scalar, rp_global, result_2d = ipa_attention(
                q_scalar * scalar_weights, k_scalar, v_scalar, q_point,
                k_point, v_point, pw, pair_bias, mask, inputs_2d)
            result_point_global = rp_global.reshape(b, l, h * npv, 3)
        else:
            attn_qk_scalar = torch.einsum(
                'bihc,bjhc->bhij', q_scalar * scalar_weights, k_scalar)
            q2 = torch.sum(torch.square(q_point), dim=(-1, -2))
            k2 = torch.sum(torch.square(k_point), dim=(-1, -2))
            cross = torch.einsum('bihnr,bjhnr->bhij', q_point, k_point)
            dist2 = (q2.permute(0, 2, 1)[:, :, :, None]
                     + k2.permute(0, 2, 1)[:, :, None, :] - 2.0 * cross)
            attn_logits = (attn_qk_scalar.float()
                           + pw[None, :, None, None] * dist2
                           + pair_bias.float())
            mask_2d = mask[:, None, :, None] * mask[:, None, None, :]
            attn_logits = attn_logits + (1.0 - mask_2d) * BIG_NEG
            attn = torch.softmax(attn_logits, dim=-1)
            result_scalar = torch.einsum('bhij,bjhc->bihc', attn.to(dt),
                                         v_scalar).reshape(b, l, h * nsv)
            result_point_global = torch.einsum(
                'bhij,bjhnr->bihnr', attn, v_point).reshape(b, l, h * npv, 3)
            if kernels and registry.use_ipa_attend_kernel():
                result_2d = ipa_pair_attend(attn, inputs_2d)
            else:
                result_2d = torch.einsum(
                    'bhij,bijc->bihc', attn.to(dt), inputs_2d).reshape(
                        b, l, h * inputs_2d.shape[-1])

        result_point_local = rigids.invert().apply(result_point_global)
        outputs = [
            result_scalar,
            result_point_local.transpose(2, 3).reshape(
                b, l, 3 * h * npv).to(dt),
            torch.sqrt(torch.sum(torch.square(result_point_local), dim=-1)
                       + self.dist_epsilon).to(dt),
            result_2d,
        ]
        return self.final_proj(torch.cat(outputs, dim=-1))


class TorsionModule(nn.Module):
    """ResNet torsion predictor."""

    def __init__(self, config, c_in: int, dtype=torch.float32):
        super().__init__()
        tc = config.num_channel
        self.num_residual_block = config.num_residual_block
        self.proj_act = Linear(c_in, tc, 'linear', dtype=dtype)
        self.proj_init_act = Linear(c_in, tc, 'linear', dtype=dtype)
        for i in range(self.num_residual_block):
            self.add_module(f'block_{i}_linear1',
                            Linear(tc, tc, 'relu', dtype=dtype))
            self.add_module(f'block_{i}_linear2',
                            Linear(tc, tc, 'final', dtype=dtype))
        self.projection = Linear(tc, 14, 'linear', dtype=dtype)

    def forward(self, act, init_act):
        act = self.proj_act(torch.relu(act))
        act = act + self.proj_init_act(torch.relu(init_act))
        for i in range(self.num_residual_block):
            res = getattr(self, f'block_{i}_linear1')(torch.relu(act))
            res = getattr(self, f'block_{i}_linear2')(torch.relu(res))
            act = act + res
        angles = self.projection(torch.relu(act))
        return angles.reshape(angles.shape[:-1] + (7, 2))


class IpaScore(nn.Module):
    """Structure module over noisy rigids, emitting SE(3) scores."""

    def __init__(self, config, diffuser, seq_c: int, pair_c: int,
                 dtype=torch.float32):
        super().__init__()
        c = config.IPA
        self.config = config
        self.diffuser = diffuser
        self.dtype = dtype
        nc, ec = c.num_channel, config.edge_embed_size
        self.proj_init_seq_act = Linear(seq_c, nc, 'linear', dtype=dtype)
        self.proj_init_pair_act = Linear(pair_c, ec, 'linear', dtype=dtype)
        self.init_seq_norm = LayerNorm(nc, dtype=dtype)
        self.init_pair_norm = LayerNorm(ec, dtype=dtype)
        self.proj_seq = Linear(nc, nc, 'linear', dtype=dtype)
        self.ipa = InvariantPointAttention(c, nc, ec, dtype=dtype)
        self.attention_norm = LayerNorm(nc, dtype=dtype)
        n_tr = c.num_layer_in_transition
        for k in range(n_tr):
            self.add_module(f'transition_{k}', Linear(
                nc, nc, 'linear' if k == n_tr - 1 else 'final', dtype=dtype))
        self.transition_norm = LayerNorm(nc, dtype=dtype)
        self.affine_update = Linear(nc, 6, 'final', dtype=dtype)
        self.torsion_module = TorsionModule(c.torsion, nc, dtype=dtype)

    @annotated('abx.ipa')
    def forward(self, representations, batch, generator=None):
        """`generator` draws the dropout in train() mode."""
        c = self.config.IPA
        ps = c.position_scale
        b, l = batch['seq_t'].shape
        node_mask = batch['mask'].float()
        fixed_mask = batch['fixed_mask'].float()
        init_rigids7 = batch['rigids_t'].float()
        init_quats = init_rigids7[..., :4]
        init_trans = init_rigids7[..., 4:]

        seq_act = self.init_seq_norm(
            self.proj_init_seq_act(representations['seq']))
        pair_act = self.init_pair_norm(
            self.proj_init_pair_act(representations['pair']))
        initial_seq_act = seq_act
        seq_act = self.proj_seq(seq_act)
        pair_bias = self.ipa.compute_pair_bias(pair_act)
        transition = [getattr(self, f'transition_{k}')
                      for k in range(c.num_layer_in_transition)]

        delta_quat = quat_ops.identity_quat((b, l), device=init_quats.device)
        curr_quats = init_quats
        curr_trans = init_trans / ps
        curr_rots = quat_ops.quat_to_rot(curr_quats)

        def apply_mask(diff, fixed):
            m = (1.0 - fixed_mask)[..., None]
            return m * diff + (1.0 - m) * fixed

        def dropout(x):
            if not self.training:
                return x
            return shared_dropout(x, c.dropout, generator)

        traj = []
        for it in range(c.num_layer):
            rig = Rigid(curr_rots, curr_trans)
            seq_act = seq_act + self.ipa(seq_act, pair_act, node_mask, rig,
                                         pair_bias)
            seq_act = self.attention_norm(dropout(seq_act))
            res = seq_act
            for k, layer in enumerate(transition):
                res = layer(res)
                if k < len(transition) - 1:
                    res = torch.relu(res)
            seq_act = self.transition_norm(dropout(seq_act + res))

            update = self.affine_update(seq_act).float()
            quat_update, trans_update = update[..., :3], update[..., 3:]
            delta_quat = quat_ops.quat_precompose_vec(delta_quat, quat_update)
            curr_quats = quat_ops.quat_precompose_vec(curr_quats, quat_update)
            curr_trans = Rigid(curr_rots, curr_trans).apply(trans_update)
            curr_quats = apply_mask(curr_quats, init_quats)
            curr_trans = apply_mask(curr_trans, init_trans / ps)
            curr_rots = quat_ops.quat_to_rot(curr_quats)
            traj.append(Rigid(curr_rots, curr_trans * ps))
            if it < c.num_layer - 1:
                curr_rots = curr_rots.detach()
                curr_quats = curr_quats.detach()

        unnorm_angles = self.torsion_module(seq_act, initial_seq_act).float()
        angles = unnorm_angles / torch.sqrt(torch.sum(
            torch.square(unnorm_angles), dim=-1, keepdim=True) + 1e-12)
        gt_torsions = batch['torsion_angles_sin_cos'].float()
        fm = fixed_mask[..., None, None] > 0
        angles = torch.where(fm, gt_torsions, angles)
        unnorm_angles = torch.where(fm, gt_torsions, unnorm_angles)

        curr_quats_final = apply_mask(
            quat_ops.quat_multiply(init_quats, delta_quat), init_quats)
        t = batch['t']
        rot_score = self.diffuser.calc_quat_score(init_quats,
                                                  curr_quats_final, t)
        trans_score = self.diffuser.calc_trans_score(init_trans,
                                                     curr_trans * ps, t)
        return {
            'traj': traj,
            'angles_sin_cos': angles,
            'unnormalized_angles_sin_cos': unnorm_angles,
            'trans_score': trans_score,
            'rot_score': rot_score,
            'structure_act': seq_act,
            'rigids': torch.cat([curr_quats_final, curr_trans * ps], dim=-1),
        }
