"""Continuous-time uniform-rate discrete diffusion over amino-acid types.

Counterpart of abx_tpu/diffusion/discrete.py: a CTMC with uniform
off-diagonal rate over S=20 states, its closed-form transition kernel,
tau-leaping reverse jumps driven by model logits, and the Gibbs corrector
(forward + reverse rates at a fixed time).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from abx_tpu_torch.common import residue_constants as rc


def poisson_counts_from_uniform(lam, u, max_k: int = 16):
    """Poisson counts by inverse CDF from shared uniforms `u` — the same
    forward pmf recurrence and op order as the JAX package, so identical
    rates and uniforms give identical jump counts."""
    term = torch.exp(-lam)
    cdf = term
    counts = (u > cdf).long()
    for j in range(1, max_k):
        term = term * lam / j
        cdf = cdf + term
        counts = counts + (u > cdf).long()
    return counts


@dataclasses.dataclass(frozen=True)
class DiscreteConfig:
    rate_const: float = 0.3
    num_states: int = rc.restype_num


class DiscreteDiffuser:
    def __init__(self, config: DiscreteConfig = DiscreteConfig()):
        self.config = config

    @property
    def num_states(self):
        return self.config.num_states

    def rate_matrix(self, device):
        c, s = self.config.rate_const, self.num_states
        rate = c * (torch.ones((s, s), device=device)
                    - torch.eye(s, device=device))
        return rate - torch.diag(torch.sum(rate, dim=1))

    def rate(self, t):
        """(B, S, S) rate matrix (time-independent)."""
        r = self.rate_matrix(t.device)
        return r.expand((t.shape[0],) + r.shape)

    def transition(self, t):
        """exp(t * R) in closed form, tiny values snapped to 0."""
        s = self.num_states
        decay = torch.exp(-self.config.rate_const * s * t)
        uniform = torch.full((s, s), 1.0 / s, device=t.device)
        delta = torch.eye(s, device=t.device) - uniform
        q = uniform[None] + decay[:, None, None] * delta[None]
        return torch.where(q < 1e-8, torch.zeros_like(q), q)

    def sample_ref(self, generator, shape, device):
        return torch.randint(0, self.num_states, tuple(shape),
                             generator=generator, device=device)

    def forward_marginal(self, generator, x_0, t):
        """Sample x_t ~ q(x_t | x_0) plus one auxiliary corrupted site per
        example (the tauLDR one-forward-pass scheme: the network reads the
        corrupted x_tilde).  Returns (x_tilde, q_t0, rate_t, x_t), x_t
        before the corruption."""
        s = self.num_states
        batch, length = x_0.shape
        qt0 = self.transition(t)
        rate = self.rate(t)
        x_0 = x_0.clamp(0, s - 1).long()
        rows = torch.gather(qt0, 1, x_0[..., None].expand(-1, -1, s))
        x_t = torch.multinomial(rows.reshape(-1, s), 1,
                                generator=generator).reshape(batch, length)
        # Rate rows at the sampled state, diagonal zeroed.
        rate_rows = torch.gather(rate, 1, x_t[..., None].expand(-1, -1, s))
        rate_rows = (rate_rows * (1.0 - F.one_hot(x_t, s).float())
                     ).clamp(min=0.0)
        # One site per example in proportion to its total outgoing rate,
        # then its new value in proportion to that site's rates.
        site = torch.multinomial(rate_rows.sum(-1), 1, generator=generator)
        site_rates = torch.gather(rate_rows, 1,
                                  site[..., None].expand(-1, -1, s))[:, 0]
        new_val = torch.multinomial(site_rates, 1, generator=generator)
        return x_t.scatter(1, site, new_val), qt0, rate, x_t

    def reverse_rates(self, x_t, logits_t, t, eps_ratio: float = 1e-9):
        """Model-implied reverse jump rates R̂_t(x_t -> s), (B, D, S)."""
        batch = x_t.shape[0]
        s = self.num_states
        t_vec = torch.as_tensor(t, dtype=torch.float32,
                                device=logits_t.device).expand(batch)
        x_t = x_t.clamp(0, s - 1).long()
        p0t = torch.softmax(logits_t.float(), dim=-1)
        qt0 = self.transition(t_vec)
        rate = self.rate(t_vec)
        idx = x_t[:, None, :].expand(-1, s, -1)
        qt0_denom = torch.gather(qt0, 2, idx).transpose(1, 2) + eps_ratio
        forward_rates = torch.gather(rate, 2, idx).transpose(1, 2)
        inner = torch.einsum('bds,bsk->bdk', p0t / qt0_denom, qt0)
        return forward_rates * inner * (1.0 - F.one_hot(x_t, s).float())

    def corrector_rates(self, x_t, logits_t, t, eps_ratio: float = 1e-9):
        """Gibbs-corrector jump rates at fixed time t, (B, D, S): the
        reverse rates plus the forward rates out of x_t, diagonal zeroed.
        The CTMC with generator R_t + R̂_t is stationary w.r.t. the noising
        marginal q_t when the model posterior is exact, so extra jumps at
        fixed t pull the sampled marginal back toward q_t."""
        s = self.num_states
        rev = self.reverse_rates(x_t, logits_t, t, eps_ratio=eps_ratio)
        t_vec = torch.as_tensor(t, dtype=torch.float32,
                                device=logits_t.device).expand(x_t.shape[0])
        x_i = x_t.clamp(0, s - 1).long()
        fwd = torch.gather(self.rate(t_vec), 1,
                           x_i[..., None].expand(-1, -1, s))
        fwd = fwd * (1.0 - F.one_hot(x_i, s).float())
        return (rev + fwd).clamp(min=0.0)

    def _leap(self, generator, x_t, rates, dt, u):
        """One tau-leap from x_t with the given jump rates: Poisson jump
        counts (from `generator`, or by inverse CDF from uniforms `u`), net
        displacement, clip."""
        s = self.num_states
        diffs = torch.arange(s, device=x_t.device)[None, None, :] \
            - x_t[:, :, None]
        if u is None:
            jump_nums = torch.poisson(rates * dt, generator=generator).long()
        else:
            jump_nums = poisson_counts_from_uniform(rates * dt, u)
        overall_jump = torch.sum(jump_nums * diffs, dim=-1)
        return (x_t + overall_jump).clamp(0, s - 1)

    def reverse(self, generator, x_t, logits_t, t, dt,
                eps_ratio: float = 1e-9, u: Optional[torch.Tensor] = None):
        """Tau-leaping reverse jump step; `u` (B, D, S) uniforms draw the
        Poisson counts by inverse CDF (shared-noise parity harness)."""
        x_t = x_t.clamp(0, self.num_states - 1).long()
        rates = self.reverse_rates(x_t, logits_t, t, eps_ratio=eps_ratio)
        return self._leap(generator, x_t, rates, dt, u)

    def corrector(self, generator, x_t, logits_t, t, dt,
                  eps_ratio: float = 1e-9, u: Optional[torch.Tensor] = None):
        """One tau-leaping Gibbs-corrector step at fixed time t: the
        reverse step's leap over `corrector_rates`, so repeated steps
        equilibrate toward q_t instead of advancing time.  `dt` is the
        leap size (the sampler's dt * corrector_scale)."""
        x_t = x_t.clamp(0, self.num_states - 1).long()
        rates = self.corrector_rates(x_t, logits_t, t, eps_ratio=eps_ratio)
        return self._leap(generator, x_t, rates, dt, u)
