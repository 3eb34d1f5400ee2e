"""Rigid transforms: `Rigid(rot (..., 3, 3), trans (..., 3))` over tensors.

For the reference (the plain math of the port's `geometry/rigid.py`).
The 3x3 contractions are
written as broadcast products summed in f32, so no matmul precision mode
(TF32) can touch the frame math.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark.reference import quat as quat_ops


def _matvec(rot, v):
    """(..., 3, 3) x (..., 3) -> (..., 3)."""
    return torch.sum(rot * v[..., None, :], dim=-1)


def _matmul(a, b):
    """(..., 3, 3) x (..., 3, 3) -> (..., 3, 3)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


class Rigid(NamedTuple):
    rot: torch.Tensor    # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)

    @staticmethod
    def from_tensor4x4(m) -> 'Rigid':
        return Rigid(m[..., :3, :3], m[..., :3, 3])

    @staticmethod
    def from_quat_trans(q, trans) -> 'Rigid':
        return Rigid(quat_ops.quat_to_rot(q), trans)

    def to_tensor7(self):
        return torch.cat([quat_ops.rot_to_quat(self.rot), self.trans], dim=-1)

    def apply(self, points):
        """points (..., 3) with the batch shape of `trans`, or (..., M, 3)
        for M points per rigid."""
        if points.dim() == self.trans.dim():
            return self.trans + _matvec(self.rot, points)
        return self.trans[..., None, :] + _matvec(self.rot[..., None, :, :],
                                                  points)

    def invert(self) -> 'Rigid':
        inv_rot = self.rot.transpose(-1, -2)
        return Rigid(inv_rot, -_matvec(inv_rot, self.trans))

    def compose(self, other: 'Rigid') -> 'Rigid':
        """self o other (apply `other` first in the local frame)."""
        return Rigid(_matmul(self.rot, other.rot),
                     self.trans + _matvec(self.rot, other.trans))

    def compose_rot(self, rot) -> 'Rigid':
        return Rigid(_matmul(self.rot, rot), self.trans)

    def map(self, fn: Callable) -> 'Rigid':
        return Rigid(fn(self.rot), fn(self.trans))

    def __getitem__(self, idx) -> 'Rigid':
        """Index the batch shape (trailing 3x3 / 3 axes are preserved)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Rigid(self.rot[idx + (slice(None), slice(None))],
                     self.trans[idx + (slice(None),)])


def _robust_normalize(v, eps: float = 1e-8):
    return v / torch.sqrt(torch.sum(torch.square(v), dim=-1, keepdim=True)
                          + eps)


def rigids_from_3_points(point_on_neg_x_axis, origin, point_on_xy_plane,
                         eps: float = 1e-8) -> Rigid:
    """Gram-Schmidt frame construction."""
    e0 = _robust_normalize(origin - point_on_neg_x_axis, eps)
    e1u = point_on_xy_plane - origin
    e1 = e1u - torch.sum(e1u * e0, dim=-1, keepdim=True) * e0
    e1 = _robust_normalize(e1, eps)
    e2 = torch.cross(e0, e1, dim=-1)
    rot = torch.stack([e0, e1, e2], dim=-1)
    return Rigid(rot, origin)
