"""Continuous-time uniform-rate discrete diffusion over amino-acid types.

For the reference (the plain math of the port's
`diffusion/discrete.py`): a CTMC with uniform
off-diagonal rate over S=20 states, its closed-form transition kernel,
and tau-leaping reverse jumps driven by model logits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from benchmark.reference import residue_constants as rc


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

    def reverse(self, generator, x_t, logits_t, t, dt,
                eps_ratio: float = 1e-9):
        """One tau-leap from x_t with the model's reverse rates: Poisson
        jump counts from `generator`, net displacement, clip."""
        s = self.num_states
        x_t = x_t.clamp(0, s - 1).long()
        rates = self.reverse_rates(x_t, logits_t, t, eps_ratio=eps_ratio)
        diffs = torch.arange(s, device=x_t.device)[None, None, :] \
            - x_t[:, :, None]
        jump_nums = torch.poisson(rates * dt, generator=generator).long()
        overall_jump = torch.sum(jump_nums * diffs, dim=-1)
        return (x_t + overall_jump).clamp(0, s - 1)
