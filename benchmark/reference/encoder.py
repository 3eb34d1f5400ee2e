"""Structural context encoders of the reference model: per-residue and
pairwise embeddings of the fixed residues (diffused residues are masked to
zero), in float32."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import frames as frame_ops
from benchmark.reference import residue_constants as rc
from benchmark.reference.modules import MLP, Embedding


class ResidueEmbedding(nn.Module):
    """Per-residue structural encoder."""

    def __init__(self, seq_channel: int):
        super().__init__()
        f = seq_channel
        self.aatype_embed = Embedding(rc.restype_num + 3, f)
        self.cdr_embed = Embedding(rc.num_ab_regions + 1, f)
        self.coordinate_embed = MLP(14 * 3 + 7 * 2, (f, f))
        self.mlp = MLP(f + 1 + 1 + f + f, (f * 2, f, f, f))

    def forward(self, batch):
        mask = torch.logical_and(batch['mask'] > 0, batch['fixed_mask'] > 0)
        n, l = mask.shape
        maskf = mask[:, :, None].float()
        aa_feat = self.aatype_embed(batch['seq_t']) * maskf
        cdr_feat = self.cdr_embed(batch['cdr_def'])
        coords = batch['atom14_gt_positions'].reshape(n, l, -1).float()
        torsions = batch['torsion_angles_sin_cos'].reshape(n, l, -1).float()
        coord_feat = self.coordinate_embed(torch.cat([coords, torsions], -1))
        feats = torch.cat([
            aa_feat,
            batch['chain_id'][..., None].float(),
            batch['residx'][..., None].float(),
            cdr_feat, coord_feat,
        ], dim=-1)
        return self.mlp(feats) * maskf


class PairEmbedding(nn.Module):
    """Pairwise structural encoder."""

    def __init__(self, pair_channel: int, dgram_num_bins: int = 15,
                 dgram_min_bin: float = 3.375, dgram_max_bin: float = 21.375,
                 max_relpos: int = 32):
        super().__init__()
        f = pair_channel
        n_aa = rc.restype_num + 3
        self.max_relpos = max_relpos
        self.dgram = (dgram_num_bins, dgram_min_bin, dgram_max_bin)
        self.aa_pair_embed = Embedding(n_aa * n_aa, f)
        self.relpos_embed = Embedding(2 * max_relpos + 1, f)
        self.aapair_to_distcoef = nn.Parameter(torch.zeros(n_aa * n_aa,
                                                           14 * 14))
        self.distance_embed = MLP(14 * 14, (f, f), final_activation=True)
        self.dgram_embed = Embedding(dgram_num_bins, f)
        self.out_mlp = MLP(4 * f, (f, f, f))

    def forward(self, batch):
        n_aa = rc.restype_num + 3
        mask = torch.logical_and(batch['mask'] > 0, batch['fixed_mask'] > 0)
        mask_pair = (mask[:, :, None] & mask[:, None, :]).float()
        aa = batch['seq_t'].long()
        chain_ids = batch['chain_id']
        residx = batch['residx']
        aa_pair = aa[:, :, None] * n_aa + aa[:, None, :]
        feat_aapair = self.aa_pair_embed(aa_pair)
        same_chain = chain_ids[:, :, None] == chain_ids[:, None, :]
        relpos = torch.clamp(residx[:, :, None] - residx[:, None, :],
                             -self.max_relpos, self.max_relpos)
        feat_relpos = self.relpos_embed(relpos + self.max_relpos) \
            * same_chain[..., None].float()
        dist2 = batch['static_pair_dist2'].float()
        mask_atom_pair = batch['static_pair_atom_mask'].float()
        distance_coef = F.softplus(self.aapair_to_distcoef[aa_pair].float())
        d_gauss = torch.exp(-distance_coef * dist2)
        feat_dist = self.distance_embed(d_gauss * mask_atom_pair)
        disto_bins = frame_ops.dgram_from_positions(
            batch['static_pseudo_beta_fixed'], *self.dgram)
        feat_dgram = self.dgram_embed(disto_bins)
        feat_all = torch.cat(
            [feat_aapair, feat_relpos, feat_dist, feat_dgram], dim=-1)
        return self.out_mlp(feat_all) * mask_pair[..., None]
