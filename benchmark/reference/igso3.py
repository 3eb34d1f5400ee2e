"""IGSO(3) score-based diffusion on rotations, for the reference: the
pdf / cdf / score-norm tables from the truncated power series, built in
float64 numpy (never read from a cache) and moved to the device as float32
constants."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference import quat as quat_ops
from benchmark.reference.quat import safe_norm


@dataclasses.dataclass(frozen=True)
class SO3Config:
    num_omega: int = 1000
    num_sigma: int = 1000
    min_sigma: float = 0.1
    max_sigma: float = 1.5
    schedule: str = 'logarithmic'
    expansion_levels: int = 1000


def igso3_tables(omega: np.ndarray, sigmas: np.ndarray, levels: int):
    """pdf and score-norm tables (num_sigma, num_omega) in float64.

    The truncated IGSO(3) series, with the
    sums over the levels l taken as matrix products: the sigma-dependent
    factor (2l+1) exp(-l(l+1) sigma^2 / 2) times omega-dependent factors.
    """
    ls = np.arange(levels, dtype=np.float64)
    a = (2 * ls + 1)[None, :] * np.exp(
        -ls[None, :] * (ls[None, :] + 1) * sigmas[:, None] ** 2 / 2.0)
    arg = omega[None, :] * (ls[:, None] + 0.5)           # (levels, omega)
    hi, dhi = np.sin(arg), (ls[:, None] + 0.5) * np.cos(arg)
    lo, dlo = np.sin(omega / 2.0), 0.5 * np.cos(omega / 2.0)
    expansion = a @ (hi / lo)
    d_sigma = a @ ((lo * dhi - hi * dlo) / lo**2)
    pdf = expansion * (1 - np.cos(omega)) / np.pi
    return pdf, d_sigma / (expansion + 1e-4)


def interp(x, xp, fp):
    """Row-wise `numpy.interp`: x (N, K), xp/fp (N, P) increasing xp."""
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx = idx.clamp(1, xp.shape[-1] - 1)
    x0, x1 = torch.gather(xp, -1, idx - 1), torch.gather(xp, -1, idx)
    f0, f1 = torch.gather(fp, -1, idx - 1), torch.gather(fp, -1, idx)
    w = (x - x0) / torch.where(x1 > x0, x1 - x0, torch.ones_like(x1))
    out = f0 + w * (f1 - f0)
    out = torch.where(x <= xp[:, :1], fp[:, :1], out)
    return torch.where(x >= xp[:, -1:], fp[:, -1:], out)


class SO3Diffuser:
    """IGSO(3) diffuser with device-resident tables."""

    def __init__(self, config: SO3Config = SO3Config(), device='cpu'):
        self.config = c = config
        if c.schedule != 'logarithmic':
            raise ValueError(f'Unknown schedule {c.schedule}')
        self._np_omega = np.linspace(0, np.pi, c.num_omega + 1)[1:]
        ts = np.linspace(0.0, 1.0, c.num_sigma)
        self._np_sigma_grid = np.log(
            ts * np.exp(c.max_sigma) + (1 - ts) * np.exp(c.min_sigma))
        _, cdf, score_norms = self._tables()

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.discrete_omega = dev(self._np_omega)
        self.discrete_sigma = dev(self._np_sigma_grid)
        self._cdf = dev(cdf)
        self._score_norms = dev(score_norms)

    def _tables(self):
        """The tables, computed here (the reference reads no cache)."""
        c = self.config
        pdf, score_norms = igso3_tables(self._np_omega, self._np_sigma_grid,
                                        c.expansion_levels)
        cdf = np.cumsum(pdf, axis=-1) / c.num_omega * np.pi
        return pdf, cdf, score_norms

    def sigma(self, t):
        c = self.config
        return torch.log(t * np.exp(c.max_sigma)
                         + (1 - t) * np.exp(c.min_sigma))

    def diffusion_coef(self, t):
        c = self.config
        sigma_t = self.sigma(t)
        return torch.sqrt(
            2 * (np.exp(c.max_sigma) - np.exp(c.min_sigma))
            * sigma_t / torch.exp(sigma_t))

    def t_to_idx(self, t):
        sigma = self.sigma(t)
        return torch.sum(
            (self.discrete_sigma[None, ...] <= sigma[..., None] + 1e-5)
            .long(), dim=-1) - 1

    def sample_igso3(self, generator, t, shape):
        """Inverse-CDF sample of rotation angles; t (B,), shape (B, ...)."""
        x = torch.rand(shape, generator=generator, device=t.device)
        cdf_rows = self._cdf[self.t_to_idx(t)]
        flat_x = x.reshape(x.shape[0], -1)
        omega = interp(flat_x, cdf_rows,
                       self.discrete_omega.expand_as(cdf_rows))
        return omega.reshape(shape)

    def sample(self, generator, t, shape):
        """IGSO(3) rotation-vector samples of shape (*shape, 3)."""
        axis = torch.randn(tuple(shape) + (3,), generator=generator,
                           device=t.device)
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        return axis * self.sample_igso3(generator, t, tuple(shape))[..., None]

    def sample_ref(self, generator, shape, device):
        t = torch.ones((shape[0],), device=device)
        return self.sample(generator, t, shape)

    def score(self, vec, t, eps: float = 1e-6):
        """Score of the IGSO(3) density at rotation vectors `vec` (B, L, 3)."""
        omega = safe_norm(vec, keepdim=False) + eps
        score_norms_t = self._score_norms[self.t_to_idx(t)]
        omega_idx = torch.searchsorted(
            self.discrete_omega[:-1].contiguous(), omega.contiguous(),
            side='left')
        omega_scores = torch.gather(score_norms_t, -1, omega_idx)
        return omega_scores[..., None] * vec / (omega[..., None] + eps)

    def reverse(self, generator, rot_t, score_t, t, dt,
                mask: Optional[torch.Tensor] = None,
                noise_scale: float = 1.0):
        """One geodesic-random-walk reverse step; the normal draw is scaled
        by `noise_scale`."""
        g_t = self.diffusion_coef(t)[:, None, None]
        z = noise_scale * torch.randn(score_t.shape, generator=generator,
                                      device=score_t.device)
        perturb = (g_t**2) * score_t * dt + g_t * np.sqrt(dt) * z
        if mask is not None:
            perturb = perturb * mask[..., None]
        quat_t1 = quat_ops.quat_multiply(
            quat_ops.rotvec_to_quat(rot_t), quat_ops.rotvec_to_quat(perturb))
        return quat_ops.quat_to_rotvec(quat_t1)
