"""Quaternion algebra, scalar-first (w, x, y, z) Hamilton convention.

For the reference (the plain math of the port's `geometry/quat.py`).
"""

from __future__ import annotations

import torch

from benchmark.reference.tensor import l2_normalize


def identity_quat(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2; both (..., 4) scalar-first."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_multiply_by_vec(q, v):
    """q * (0, v) — the IPA affine update."""
    w1, x1, y1, z1 = q.unbind(-1)
    x2, y2, z2 = v.unbind(-1)
    return torch.stack([
        -x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2,
    ], dim=-1)


def quat_precompose_vec(q, vec_update):
    """AF2-style affine update: normalize(q + q * (0, vec))."""
    return l2_normalize(q + quat_multiply_by_vec(q, vec_update), dim=-1)


def invert_quat(q):
    """Conjugate divided by norm."""
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                        device=q.device)
    return q * sign / torch.sqrt(torch.sum(torch.square(q), dim=-1,
                                           keepdim=True))


def quat_to_rot(q):
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3); no input
    normalization (non-unit inputs scale the result)."""
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xy, xz, yz = 2 * x * y, 2 * x * z, 2 * y * z
    m = torch.stack([
        ww + xx - yy - zz, xy - wz, xz + wy,
        xy + wz, ww - xx + yy - zz, yz - wx,
        xz - wy, yz + wx, ww - xx - yy + zz,
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rot_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion, branchless
    4-candidate method with the candidate picked by argmax."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrt_pos(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    q_abs = torch.stack([
        _sqrt_pos(1.0 + m00 + m11 + m22),
        _sqrt_pos(1.0 + m00 - m11 - m22),
        _sqrt_pos(1.0 - m00 + m11 - m22),
        _sqrt_pos(1.0 - m00 - m11 + m22),
    ], dim=-1)
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cand, -2, idx).squeeze(-2)


def safe_norm(x, dim=-1, keepdim=True, tiny=1e-24):
    """L2 norm that is exactly 0 (not NaN-prone) at x == 0."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=keepdim)
    is_zero = sq < tiny
    safe_sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(safe_sq))


def _sin_half_over_angle(angles):
    """sin(angle/2)/angle with a 2nd-order Taylor branch near zero."""
    small = torch.abs(angles) < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    general = torch.sin(safe / 2.0) / safe
    taylor = 0.5 - angles * angles / 48.0
    return torch.where(small, taylor, general)


def quat_to_rotvec(q):
    """Quaternion -> axis-angle vector."""
    flip = (q[..., :1] < 0).to(q.dtype)
    q = (-q) * flip + (1.0 - flip) * q
    norms = safe_norm(q[..., 1:])
    half_angles = torch.atan2(norms, q[..., :1])
    angles = 2.0 * half_angles
    return q[..., 1:] / _sin_half_over_angle(angles)


def rotvec_to_quat(rotvec):
    """Axis-angle vector -> quaternion."""
    angles = safe_norm(rotvec)
    return torch.cat(
        [torch.cos(angles * 0.5), rotvec * _sin_half_over_angle(angles)],
        dim=-1)

