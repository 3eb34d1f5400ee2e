"""Feature pipeline of the reference (the plain math of the port's
`data/features.py`).

The same ordered transforms; the noising transform
(`make_diffuser_features`) draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from benchmark.reference import residue_constants as rc
from benchmark.reference import frames as frame_ops
from benchmark.reference.frames import table
from benchmark.reference.tensor import batched_gather

_FEATS_FN: Dict[str, Callable] = {}


def register(fn):
    _FEATS_FN[fn.__name__] = fn
    return fn


@register
def make_restype_atom_constants(batch, is_training=False):
    seq = batch['seq'].long()
    dev = seq.device
    batch['atom14_atom_exists'] = batched_gather(
        table('restype_atom14_mask', dev), seq)
    batch['atom14_atom_is_ambiguous'] = batched_gather(
        table('restype_atom14_is_ambiguous', dev), seq)
    if 'residx_atom37_to_atom14' not in batch:
        batch['residx_atom37_to_atom14'] = batched_gather(
            table('restype_atom37_to_atom14', dev), seq)
    if 'atom37_atom_exists' not in batch:
        batch['atom37_atom_exists'] = batched_gather(
            table('restype_atom37_mask', dev), seq)
    return batch


@register
def make_atom14_alt_gt_positions(batch, is_training=False):
    seq = batch['seq'].long()
    swap = batched_gather(
        table('restype_ambiguous_atoms_swap_index', seq.device), seq)
    batch['atom14_alt_gt_positions'] = batched_gather(
        batch['atom14_gt_positions'], swap, batch_dims=2)
    batch['atom14_alt_gt_exists'] = batched_gather(
        batch['atom14_gt_exists'], swap, batch_dims=2)
    return batch


def _ensure_atom37(batch):
    if 'atom37_gt_positions' not in batch:
        batch = make_restype_atom_constants(batch)
        batch['atom37_gt_positions'] = batched_gather(
            batch['atom14_gt_positions'], batch['residx_atom37_to_atom14'],
            batch_dims=2)
        batch['atom37_gt_exists'] = torch.logical_and(
            batched_gather(batch['atom14_gt_exists'],
                           batch['residx_atom37_to_atom14'],
                           batch_dims=2) > 0,
            batch['atom37_atom_exists'] > 0).float()
    return batch


@register
def make_pseudo_beta(batch, is_training=False):
    batch = _ensure_atom37(batch)
    pb, pb_mask = frame_ops.pseudo_beta(
        batch['seq'], batch['atom37_gt_positions'], batch['atom37_gt_exists'])
    batch['pseudo_beta'] = pb
    batch['pseudo_beta_mask'] = pb_mask
    return batch


@register
def make_gt_frames(batch, is_training=False):
    batch = _ensure_atom37(batch)
    batch.update(frame_ops.atom37_to_frames(
        batch['seq'].long(), batch['atom37_gt_positions'],
        batch['atom37_gt_exists']))
    return batch


@register
def make_calpha3_frames(batch, is_training=False):
    batch = _ensure_atom37(batch)
    batch.update(frame_ops.calpha3_to_frames(
        batch['atom37_gt_positions'][:, :, 1],
        batch['atom37_gt_exists'][:, :, 1]))
    return batch


@register
def make_torsion_angles(batch, is_training=False):
    batch = _ensure_atom37(batch)
    batch.update(frame_ops.atom37_to_torsion_angles(
        batch['seq'].long(), batch['atom37_gt_positions'],
        batch['atom37_gt_exists']))
    return batch


def select_cdrs_mask(anchor_flag, antibody_len, cdr_enums, mask_template):
    """Diffused-residue mask between the anchor pairs of the chosen CDRs."""
    b, l_ab = anchor_flag.shape
    dev = anchor_flag.device
    pos = torch.arange(l_ab, device=dev)
    diffused = torch.zeros((b, l_ab), dtype=torch.long, device=dev)
    for enum in cdr_enums:
        is_anchor = anchor_flag == enum
        any_anchor = torch.any(is_anchor, dim=-1)
        first = torch.argmax(is_anchor.long(), dim=-1)
        last = l_ab - 1 - torch.argmax(is_anchor.flip(-1).long(), dim=-1)
        # Parity quirk: the reference diffuses slice(first+1, last-1), so
        # the final CDR residue (at last-1) stays FIXED.
        inside = (pos[None, :] > first[:, None]) & (
            pos[None, :] < last[:, None] - 1)
        diffused = torch.where(any_anchor[:, None],
                               torch.maximum(diffused, inside.long()),
                               diffused)
    full = torch.zeros(mask_template.shape, dtype=torch.long, device=dev)
    full[:, :l_ab] = diffused
    return full


@register
def make_static_pair_features(batch, is_training=False):
    """Coordinate-derived pair-encoder inputs, computed once per
    trajectory: 14x14 interatomic squared distances, the CA pair mask and
    the fixed-coordinate pseudo-beta."""
    coords = batch['atom14_gt_positions']
    n, l = coords.shape[:2]
    dist2 = torch.sum(torch.square(
        coords[:, :, None, :, None, :] - coords[:, None, :, None, :, :]),
        dim=-1) / 100.0
    batch['static_pair_dist2'] = dist2.reshape(n, l, l, -1)
    mask_atoms = batch['atom14_gt_exists'][..., rc.atom_order['CA']]
    batch['static_pair_atom_mask'] = (
        mask_atoms[:, :, None, None] * mask_atoms[:, None, :, None])
    batch['static_pseudo_beta_fixed'] = frame_ops.pseudo_beta_virtual(coords)
    return batch


@register
def make_diffuser_features(batch, diffuser=None, generate_area='H3',
                           generator=None, mode='design',
                           is_training=False):
    """Fixed/diffused masks + the t = 1 start of a design trajectory (the
    reference sample, fixed residues imputed), drawn from `generator`."""
    if diffuser is None or generator is None or mode != 'design':
        raise ValueError('make_diffuser_features: design mode, with a '
                         'diffuser and a generator')
    anchor_flag = batch['anchor_flag'].long()
    antibody_len = anchor_flag.shape[1]
    b = batch['seq'].shape[0]
    dev = anchor_flag.device
    rigids_0 = batch['rigidgroups_gt_frames'][..., 0].to_tensor7()
    seq_0 = batch['seq'].long()
    if generate_area == 'cdr':
        cdr_enums = list(rc.cdr_str_to_enum.values())
    else:
        cdr_enums = [rc.cdr_str_to_enum[generate_area]]
    diffused_mask = select_cdrs_mask(anchor_flag, antibody_len, cdr_enums,
                                     batch['mask'])
    diffused_mask = diffused_mask * batch['mask'].long()
    feats = diffuser.sample_ref(generator, rigids_0.shape[:2],
                                impute_rigids=rigids_0, impute_seq=seq_0,
                                diffuse_mask=diffused_mask, device=dev)
    batch.update(feats)
    batch.update(t=torch.ones((b,), device=dev), fixed_mask=1 - diffused_mask,
                 rigids_0=rigids_0, diffused_mask=diffused_mask)
    return batch


class FeatureBuilder:
    """Ordered transform pipeline, config-as-data."""

    DEFAULT_PIPELINE = [
        ('make_restype_atom_constants', {}),
        ('make_atom14_alt_gt_positions', {}),
        ('make_gt_frames', {}),
        ('make_torsion_angles', {}),
        ('make_pseudo_beta', {}),
        ('make_calpha3_frames', {}),
    ]

    def __init__(self, config: Optional[Sequence] = None,
                 is_training: bool = False):
        self.config = list(config) if config is not None \
            else list(self.DEFAULT_PIPELINE)
        self.is_training = is_training

    def __call__(self, batch: Dict, **extra) -> Dict:
        batch = dict(batch)
        for name, kwargs in self.config:
            merged = dict(kwargs)
            if name == 'make_diffuser_features':
                merged.update(extra)
            batch = _FEATS_FN[name](batch, is_training=self.is_training,
                                    **merged)
        return batch
