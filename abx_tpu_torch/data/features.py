"""Device-side feature pipeline (counterpart of abx_tpu/data/features.py).

The same ordered transforms; the noising transform
(`make_diffuser_features`) draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.geometry import frames as frame_ops
from abx_tpu_torch.geometry.frames import table
from abx_tpu_torch.utils.tensor import batched_gather

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


def select_cdrs_mask(anchor_flag, antibody_len, cdr_enums, mask_template,
                     generator: Optional[torch.Generator] = None,
                     shrink_limit: int = 1, extend_limit: int = 2):
    """Diffused-residue mask between the anchor pairs of the chosen CDRs.

    With a generator (training augmentation) the subset law is the
    reference's: m ~ Uniform{1..K_present}, then a uniform size-m subset of
    the CDRs present, each boundary jittered by [-shrink, +extend].
    """
    b, l_ab = anchor_flag.shape
    dev = anchor_flag.device
    n_cdr = len(cdr_enums)
    pos = torch.arange(l_ab, device=dev)
    if generator is not None:
        present = torch.stack(
            [torch.any(anchor_flag == e, dim=-1) for e in cdr_enums], dim=-1)
        n_present = torch.clamp(present.sum(-1), min=1)
        m = (torch.rand((b,), generator=generator, device=dev)
             * n_present).long() + 1
        scores = torch.rand((b, n_cdr), generator=generator, device=dev)
        scores = torch.where(present, scores, torch.full_like(scores, -1.0))
        ranks = torch.argsort(torch.argsort(-scores, dim=-1), dim=-1)
        include = (ranks < m[:, None]) & present
        jitter = torch.randint(-shrink_limit, extend_limit + 1,
                               (b, n_cdr, 2), generator=generator,
                               device=dev)
    else:
        include = torch.ones((b, n_cdr), dtype=torch.bool, device=dev)
        jitter = torch.zeros((b, n_cdr, 2), dtype=torch.long, device=dev)
    diffused = torch.zeros((b, l_ab), dtype=torch.long, device=dev)
    for idx, enum in enumerate(cdr_enums):
        is_anchor = anchor_flag == enum
        any_anchor = torch.any(is_anchor, dim=-1) & include[:, idx]
        first = torch.argmax(is_anchor.long(), dim=-1)
        last = l_ab - 1 - torch.argmax(is_anchor.flip(-1).long(), dim=-1)
        first = torch.clamp(first - jitter[:, idx, 0], 0, l_ab - 1)
        last = torch.clamp(last + jitter[:, idx, 1], 0, l_ab - 1)
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
                           generator=None, mode='design', t_value=None,
                           is_training=False):
    """Fixed/diffused masks + the initial noisy state.

    Modes: 'train' (the forward marginal at t ~ U[0.01, 1) per example;
    with `is_training`, the diffused CDRs are the jittered random subset
    of `select_cdrs_mask`), 'design' (the t=1 reference sample, fixed
    residues imputed) and 'optimize' (the forward marginal at t = t_value,
    fixed residues kept).  All draws come from `generator`: in 'train' the
    CDR subset first, then t, then the noise."""
    if diffuser is None or generator is None:
        raise ValueError('make_diffuser_features needs a diffuser and a '
                         'generator')
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
    diffused_mask = select_cdrs_mask(
        anchor_flag, antibody_len, cdr_enums, batch['mask'],
        generator=generator if (is_training and mode == 'train') else None)
    diffused_mask = diffused_mask * batch['mask'].long()
    fixed_mask = 1 - diffused_mask
    d = diffused_mask[:, :antibody_len]
    dilated = torch.clamp(
        d + torch.roll(d, 1, dims=-1) + torch.roll(d, -1, dims=-1), 0, 1)
    struc_loss_mask = batch['mask'].long().clone()
    struc_loss_mask[:, :antibody_len] = dilated
    if mode == 'train':
        t = 0.01 + 0.99 * torch.rand((b,), generator=generator, device=dev)
        feats = diffuser.forward_marginal(generator, rigids_0, seq_0, t,
                                          diffused_mask)
    elif mode == 'design':
        t = torch.ones((b,), device=dev)
        feats = diffuser.sample_ref(generator, rigids_0.shape[:2],
                                    impute_rigids=rigids_0, impute_seq=seq_0,
                                    diffuse_mask=diffused_mask, device=dev)
    elif mode == 'optimize':
        t = torch.full((b,), float(t_value), device=dev)
        feats = diffuser.forward_marginal(generator, rigids_0, seq_0, t,
                                          diffused_mask)
    else:
        raise ValueError(f'make_diffuser_features: mode {mode!r}')
    batch.update(feats)
    batch.update(t=t, struc_loss_mask=struc_loss_mask, fixed_mask=fixed_mask,
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
