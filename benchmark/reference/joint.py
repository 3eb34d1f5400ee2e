"""Joint SE(3) x sequence diffusion for the reference (the plain math of
the port's `diffusion/joint.py`): the SO(3), R^3 and discrete diffusers
behind the interface the score network and the sampler step use, random
draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.discrete import DiscreteConfig, DiscreteDiffuser
from benchmark.reference.igso3 import SO3Config, SO3Diffuser
from benchmark.reference.r3 import R3Config, R3Diffuser
from benchmark.reference import quat as quat_ops


@dataclasses.dataclass(frozen=True)
class JointConfig:
    so3: SO3Config = SO3Config()
    r3: R3Config = R3Config()
    seq: DiscreteConfig = DiscreteConfig()
    diffuse_rot: bool = True
    diffuse_trans: bool = True
    diffuse_seq: bool = True

    @staticmethod
    def from_dict(d: dict) -> 'JointConfig':
        diffuse = d.get('diffuse', {})

        def pick(cls, sub):
            return cls(**{k: v for k, v in d.get(sub, {}).items()
                          if k in cls.__dataclass_fields__})
        return JointConfig(
            so3=pick(SO3Config, 'so3'), r3=pick(R3Config, 'r3'),
            seq=pick(DiscreteConfig, 'seq'),
            diffuse_rot=diffuse.get('diffuse_rot', True),
            diffuse_trans=diffuse.get('diffuse_trans', True),
            diffuse_seq=diffuse.get('diffuse_seq', True),
        )


def _mask_mix(x_diff, x_fixed, diff_mask):
    return diff_mask * x_diff + (1 - diff_mask) * x_fixed


def tensor7_split(rigids7):
    """tensor7 -> (trans, rotvec)."""
    return rigids7[..., 4:], quat_ops.quat_to_rotvec(rigids7[..., :4])


def tensor7_join(rotvec, trans):
    return torch.cat([quat_ops.rotvec_to_quat(rotvec), trans], dim=-1)


class JointDiffuser:
    def __init__(self, config: JointConfig = JointConfig(), device='cpu'):
        self.config = config
        self.so3 = SO3Diffuser(config.so3, device=device)
        self.r3 = R3Diffuser(config.r3)
        self.seq = DiscreteDiffuser(config.seq)

    def calc_trans_score(self, trans_t, trans_0, t, scale: bool = True):
        return self.r3.score(trans_t, trans_0, t, scale=scale)

    def calc_quat_score(self, quat_t, quat_0, t):
        """Score at rotvec(quat_0^{-1} quat_t)."""
        quats_0t = quat_ops.quat_multiply(quat_ops.invert_quat(quat_0),
                                          quat_t)
        return self.so3.score(quat_ops.quat_to_rotvec(quats_0t), t)

    def reverse(self, generator, rigids_t, seq_t, rot_score, trans_score,
                logits_t, t, dt, diffuse_mask=None, center: bool = True,
                noise_scale: float = 1.0):
        """One joint reverse step; t (B,), dt scalar.  `center` re-centres
        the translations, `noise_scale` scales the rotation and translation
        normals.  Every draw comes from `generator`, in the order SO(3),
        R^3, sequence."""
        c = self.config
        trans_t, rot_t = tensor7_split(rigids_t)
        if c.diffuse_rot:
            rot_t_1 = self.so3.reverse(generator, rot_t, rot_score, t, dt,
                                       noise_scale=noise_scale)
        else:
            rot_t_1 = rot_t
        if c.diffuse_trans:
            trans_t_1 = self.r3.reverse(generator, trans_t, trans_score, t,
                                        dt, center=center,
                                        noise_scale=noise_scale)
        else:
            trans_t_1 = trans_t
        if c.diffuse_seq:
            seq_t_1 = self.seq.reverse(generator, seq_t, logits_t, t, dt)
        else:
            seq_t_1 = seq_t
        if diffuse_mask is not None:
            m = diffuse_mask
            trans_t_1 = _mask_mix(trans_t_1, trans_t, m[..., None])
            rot_t_1 = _mask_mix(rot_t_1, rot_t, m[..., None])
            seq_t_1 = _mask_mix(seq_t_1, seq_t, m).to(seq_t.dtype)
        return tensor7_join(rot_t_1, trans_t_1), seq_t_1

    def sample_ref(self, generator, shape, impute_rigids=None,
                   impute_seq=None, diffuse_mask=None, device='cpu'):
        """Draw the t=1 reference state, imputing fixed residues."""
        c = self.config
        if impute_rigids is not None:
            trans_imp, rot_imp = tensor7_split(impute_rigids)
            trans_imp = self.r3.scale(trans_imp)
        elif diffuse_mask is not None:
            raise ValueError('diffuse_mask requires imputation values')
        rot_ref = (self.so3.sample_ref(generator, shape, device)
                   if c.diffuse_rot else rot_imp)
        trans_ref = (self.r3.sample_ref(generator, shape, device)
                     if c.diffuse_trans else trans_imp)
        seq_ref = (self.seq.sample_ref(generator, shape, device)
                   if c.diffuse_seq else impute_seq)
        if diffuse_mask is not None:
            m = diffuse_mask
            rot_ref = _mask_mix(rot_ref, rot_imp, m[..., None])
            trans_ref = _mask_mix(trans_ref, trans_imp, m[..., None])
            seq_ref = _mask_mix(seq_ref, impute_seq, m).long()
        trans_ref = self.r3.unscale(trans_ref)
        return {'rigids_t': tensor7_join(rot_ref, trans_ref),
                'seq_t': seq_ref}
