"""Backbone/side-chain frame and torsion feature math.

For the reference (the plain math of the port's `geometry/frames.py`),
from the residue-constant tables of `residue_constants.py` beside it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import residue_constants as rc
from benchmark.reference.rigid import Rigid, rigids_from_3_points
from benchmark.reference.tensor import batched_gather

_TABLES: Dict = {}


def table(name: str, device, dtype=None) -> torch.Tensor:
    """A residue-constant table as a tensor on `device` (cached)."""
    key = (name, str(device), dtype)
    t = _TABLES.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(getattr(rc, name)), device=device)
        if dtype is not None:
            t = t.to(dtype)
        elif t.is_floating_point():
            t = t.to(torch.float32)
        _TABLES[key] = t
    return t


def atom37_to_frames(aatype, atom37_pos, atom37_mask) -> Dict:
    """Ground-truth rigid-group frames (B, L, 8) from atom37 coordinates."""
    dev = atom37_pos.device
    base_idx = batched_gather(
        table('restype_rigidgroup_base_atom37_idx', dev), aatype)
    base_pos = batched_gather(atom37_pos, base_idx, batch_dims=2)
    frames = rigids_from_3_points(
        base_pos[..., 0, :], base_pos[..., 1, :], base_pos[..., 2, :])
    group_exists = batched_gather(table('restype_rigidgroup_mask', dev),
                                  aatype)
    atoms_exist = batched_gather(atom37_mask, base_idx, batch_dims=2)
    gt_exists = torch.logical_and(torch.all(atoms_exist > 0, dim=-1),
                                  group_exists > 0)
    flip = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    flip[0, 0, 0] = -1.0
    flip[0, 2, 2] = -1.0
    frames = frames.compose_rot(torch.as_tensor(flip, device=dev))
    is_ambiguous = batched_gather(
        table('restype_rigidgroup_is_ambiguous', dev), aatype)
    ambiguity_rot = batched_gather(table('restype_rigidgroup_rots', dev),
                                   aatype)
    alt_frames = frames.compose_rot(ambiguity_rot)
    return {
        'rigidgroups_gt_frames': frames,
        'rigidgroups_gt_exists': gt_exists.float(),
        'rigidgroups_group_exists': group_exists,
        'rigidgroups_group_is_ambiguous': is_ambiguous,
        'rigidgroups_alt_gt_frames': alt_frames,
    }


def atom37_to_torsion_angles(aatype, atom37_pos, atom37_mask) -> Dict:
    """7 torsion angles (pre-omega, phi, psi, chi1-4) as sin/cos."""
    dev = atom37_pos.device
    num_batch, num_res = aatype.shape
    pad_pos = F.pad(atom37_pos[:, :-1], (0, 0, 0, 0, 1, 0))
    pad_mask = F.pad(atom37_mask[:, :-1], (0, 0, 1, 0))

    pre_omega_atom_pos = torch.cat(
        [pad_pos[:, :, 1:3], atom37_pos[:, :, 0:2]], dim=-2)
    phi_atom_pos = torch.cat(
        [pad_pos[:, :, 2:3], atom37_pos[:, :, 0:3]], dim=-2)
    psi_atom_pos = torch.cat(
        [atom37_pos[:, :, 0:3], atom37_pos[:, :, 4:5]], dim=-2)

    pre_omega_mask = torch.logical_and(
        torch.all(pad_mask[:, :, 1:3] > 0, dim=-1),
        torch.all(atom37_mask[:, :, 0:2] > 0, dim=-1))
    phi_mask = torch.logical_and(
        pad_mask[:, :, 2] > 0, torch.all(atom37_mask[:, :, 0:3] > 0, dim=-1))
    psi_mask = torch.logical_and(
        torch.all(atom37_mask[:, :, 0:3] > 0, dim=-1),
        atom37_mask[:, :, 4] > 0)

    chi_atom_idx = batched_gather(table('chi_angles_atom_indices', dev),
                                  aatype)
    chis_atom_pos = batched_gather(atom37_pos, chi_atom_idx, batch_dims=2)
    chis_mask = batched_gather(table('chi_angles_mask', dev), aatype)
    chi_atoms_mask = batched_gather(atom37_mask, chi_atom_idx, batch_dims=2)
    chis_mask = chis_mask * torch.all(chi_atoms_mask > 0, dim=-1)

    torsions_atom_pos = torch.cat([
        pre_omega_atom_pos[:, :, None],
        phi_atom_pos[:, :, None],
        psi_atom_pos[:, :, None],
        chis_atom_pos,
    ], dim=2)
    torsion_angles_mask = torch.cat([
        pre_omega_mask[:, :, None].float(),
        phi_mask[:, :, None].float(),
        psi_mask[:, :, None].float(),
        chis_mask.float(),
    ], dim=2)

    torsion_frames = rigids_from_3_points(
        torsions_atom_pos[..., 1, :],
        torsions_atom_pos[..., 2, :],
        torsions_atom_pos[..., 0, :])
    fourth_atom_rel = torsion_frames.invert().apply(
        torsions_atom_pos[..., 3, :])
    sin_cos = torch.stack(
        [fourth_atom_rel[..., 2], fourth_atom_rel[..., 1]], dim=-1)
    sin_cos = sin_cos / torch.sqrt(
        torch.sum(torch.square(sin_cos), dim=-1, keepdim=True) + 1e-8)
    sin_cos = sin_cos * torch.tensor(
        [1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], device=dev)[..., None]

    chi_is_ambiguous = batched_gather(table('chi_pi_periodic', dev), aatype)
    mirror = torch.cat(
        [torch.ones((num_batch, num_res, 3), device=dev),
         1.0 - 2.0 * chi_is_ambiguous], dim=-1)
    alt_sin_cos = sin_cos * mirror[..., None]
    return {
        'torsion_angles_sin_cos': sin_cos,
        'alt_torsion_angles_sin_cos': alt_sin_cos,
        'torsion_angles_mask': torsion_angles_mask,
    }


def torsion_angles_to_frames(aatype, backb_to_global: Rigid,
                             torsion_sin_cos) -> Rigid:
    """Compose the 8 rigid-group frames (B, L, 8) from backbone + torsions."""
    dev = torsion_sin_cos.device
    default_4x4 = batched_gather(
        table('restype_rigid_group_default_frame', dev), aatype)
    default_frames = Rigid.from_tensor4x4(default_4x4)
    sin_angles = F.pad(torsion_sin_cos[..., 0], (1, 0))
    cos_angles = F.pad(torsion_sin_cos[..., 1], (1, 0), value=1.0)
    zeros = torch.zeros_like(sin_angles)
    ones = torch.ones_like(sin_angles)
    all_rots = torch.stack([
        ones, zeros, zeros,
        zeros, cos_angles, -sin_angles,
        zeros, sin_angles, cos_angles,
    ], dim=-1).reshape(sin_angles.shape + (3, 3))
    all_frames = default_frames.compose_rot(all_rots)

    chi1 = all_frames[..., 4]
    chi2 = chi1.compose(all_frames[..., 5])
    chi3 = chi2.compose(all_frames[..., 6])
    chi4 = chi3.compose(all_frames[..., 7])
    rot = torch.cat([
        all_frames.rot[..., 0:5, :, :], chi2.rot[..., None, :, :],
        chi3.rot[..., None, :, :], chi4.rot[..., None, :, :]], dim=-3)
    trans = torch.cat([
        all_frames.trans[..., 0:5, :], chi2.trans[..., None, :],
        chi3.trans[..., None, :], chi4.trans[..., None, :]], dim=-2)
    all_frames_to_backb = Rigid(rot, trans)
    bb = Rigid(backb_to_global.rot[..., None, :, :],
               backb_to_global.trans[..., None, :])
    return bb.compose(all_frames_to_backb)


def frames_to_atom14_pos(aatype, all_frames_to_global: Rigid):
    """Idealised atom14 coordinates from global rigid-group frames."""
    dev = all_frames_to_global.trans.device
    group_idx = batched_gather(table('restype_atom14_to_rigid_group', dev),
                               aatype)
    frames = all_frames_to_global.map(
        lambda x: batched_gather(x, group_idx, batch_dims=2))
    lit_positions = batched_gather(
        table('restype_atom14_rigid_group_positions', dev), aatype)
    return frames.apply(lit_positions)


def calpha3_to_frames(calpha_pos, calpha_mask=None) -> Dict:
    """Frames from consecutive C-alpha triplets."""
    def pad(x, before, after):
        cfg = [0, 0] * (x.dim() - 2) + [before, after]
        return F.pad(x, cfg)
    prev_ca = pad(calpha_pos[:, :-1], 1, 0)
    prev2_ca = pad(calpha_pos[:, :-2], 2, 0)
    next_ca = pad(calpha_pos[:, 1:], 0, 1)
    next2_ca = pad(calpha_pos[:, 2:], 0, 2)
    left = rigids_from_3_points(prev_ca, calpha_pos, prev2_ca)
    right = rigids_from_3_points(next_ca, calpha_pos, next2_ca)
    ret = {
        'left_gt_calpha3_frame_positions': left.invert().apply(next_ca),
        'right_gt_calpha3_frame_positions': right.invert().apply(prev_ca),
    }
    if calpha_mask is not None:
        prev_m = pad(calpha_mask[:, :-1], 1, 0)
        prev2_m = pad(calpha_mask[:, :-2], 2, 0)
        next_m = pad(calpha_mask[:, 1:], 0, 1)
        next2_m = pad(calpha_mask[:, 2:], 0, 2)
        ret['left_gt_calpha3_frame_position_exists'] = (
            prev2_m * prev_m * calpha_mask * next_m) > 0
        ret['right_gt_calpha3_frame_position_exists'] = (
            prev_m * calpha_mask * next_m * next2_m) > 0
    return ret


def pseudo_beta(aatype, atom37_pos, atom37_mask=None):
    """CB position (CA for glycine)."""
    is_gly = aatype == rc.restype_order['G']
    ca_idx, cb_idx = rc.atom_order['CA'], rc.atom_order['CB']
    pb = torch.where(is_gly[..., None], atom37_pos[..., ca_idx, :],
                     atom37_pos[..., cb_idx, :])
    if atom37_mask is not None:
        pb_mask = torch.where(is_gly, atom37_mask[..., ca_idx],
                              atom37_mask[..., cb_idx])
        return pb, pb_mask
    return pb


def pseudo_beta_virtual(atom_pos):
    """Virtual CB from N/CA/C (slots 0/1/2 in atom14 and atom37)."""
    n = atom_pos[..., 0, :]
    ca = atom_pos[..., 1, :]
    c = atom_pos[..., 2, :]
    b = ca - n
    cvec = c - ca
    a = torch.cross(b, cvec, dim=-1)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * cvec + ca


def dgram_from_positions(positions, num_bins, min_bin, max_bin):
    """Distance-bin indices (int64) for pair recycling features."""
    breaks = torch.linspace(min_bin, max_bin, num_bins - 1,
                            device=positions.device, dtype=torch.float32)
    sq_breaks = torch.square(breaks)
    pos = positions.float()
    dist2 = torch.sum(torch.square(pos[..., :, None, :]
                                   - pos[..., None, :, :]),
                      dim=-1, keepdim=True)
    return torch.sum((dist2 > sq_breaks).long(), dim=-1)
