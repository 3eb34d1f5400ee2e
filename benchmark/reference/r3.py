"""VP-SDE diffusion for backbone translations in R^3.

For the reference (the plain math of the port's `diffusion/r3.py`).
Parity note: the reference's
Euler-Maruyama step uses `g_t * dt * z` for the noise term instead of
`g_t * sqrt(dt) * z`; released checkpoints were sampled that way, so it is
reproduced when `parity_dt_noise=True` (default).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class R3Config:
    min_b: float = 0.1
    max_b: float = 20.0
    coordinate_scaling: float = 0.1
    parity_dt_noise: bool = True


class R3Diffuser:
    def __init__(self, config: R3Config = R3Config()):
        self.config = config

    def scale(self, x):
        return x * self.config.coordinate_scaling

    def unscale(self, x):
        return x / self.config.coordinate_scaling

    def b_t(self, t):
        c = self.config
        return c.min_b + t * (c.max_b - c.min_b)

    def marginal_b_t(self, t):
        c = self.config
        return t * c.min_b + 0.5 * t**2 * (c.max_b - c.min_b)

    def diffusion_coef(self, t):
        return torch.sqrt(self.b_t(t))[:, None, None]

    def drift_coef(self, x, t):
        return -0.5 * self.b_t(t)[:, None, None] * x

    def conditional_var(self, t):
        return 1.0 - torch.exp(-self.marginal_b_t(t))

    def score(self, x_t, x_0, t, scale: bool = False):
        """Score of p(x_t | x_0); inputs (B, L, 3), t (B,)."""
        if scale:
            x_t, x_0 = self.scale(x_t), self.scale(x_0)
        t = t[:, None, None]
        return -(x_t - torch.exp(-0.5 * self.marginal_b_t(t)) * x_0) \
            / self.conditional_var(t)

    def sample_ref(self, generator, shape, device):
        return torch.randn(tuple(shape) + (3,), generator=generator,
                           device=device)

    def reverse(self, generator, x_t, score_t, t, dt,
                mask: Optional[torch.Tensor] = None, center: bool = True,
                noise_scale: float = 1.0):
        """One Euler-Maruyama reverse step; x_t in Angstroms, the result
        re-centred on the (masked) centre of mass when `center`.  The
        normal draw is scaled by `noise_scale`."""
        x_s = self.scale(x_t)
        g_t = self.diffusion_coef(t)
        f_t = self.drift_coef(x_s, t)
        z = noise_scale * torch.randn(score_t.shape, generator=generator,
                                      device=score_t.device)
        noise_dt = dt if self.config.parity_dt_noise else float(np.sqrt(dt))
        perturb = (f_t - g_t**2 * score_t) * dt + g_t * noise_dt * z
        if mask is not None:
            perturb = perturb * mask[..., None]
        else:
            mask = torch.ones(x_t.shape[:-1], device=x_t.device)
        x_t_1 = x_s - perturb
        if center:
            com = torch.sum(x_t_1, dim=-2) / torch.sum(mask, dim=-1,
                                                       keepdim=True)
            x_t_1 = x_t_1 - com[..., None, :]
        return self.unscale(x_t_1)
