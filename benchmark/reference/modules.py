"""Plain building blocks of the reference model, in float32.

A frozen copy of the plain math of the port's `models/modules.py`, with
the parameter names of the port's modules (so one state dict loads into
either) and no compute dtype: every product is a float32 product.

`precision('fp8')` is the correctness control: inside it, every linear
layer computes in float8 e4m3, the step below the bfloat16 that the
configurations state: its input and its weight are rounded to float8 (one
scale a tensor, the tensor's max at 448) before the float32 product, and
its output is rounded to float8 as it is stored.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_PRECISION = contextvars.ContextVar('reference_precision', default='f32')
FP8_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """'f32' (the reference) or 'fp8' (the control) for the linear layers
    run inside the block."""
    if mode not in ('f32', 'fp8'):
        raise ValueError(f'precision {mode!r}')
    token = _PRECISION.set(mode)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the whole tensor."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias in float32 (in the control: in float8)."""
    x, weight = x.float(), weight.float()
    bias = None if bias is None else bias.float()
    if _PRECISION.get() == 'fp8':
        return fake_fp8(F.linear(fake_fp8(x), fake_fp8(weight), bias))
    return F.linear(x, weight, bias)


class Linear(nn.Linear):
    """nn.Linear computed by `linear` (weight (out, in))."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Two-pass float32 LayerNorm."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return out * scale.float() + bias.float()


class LayerNorm(nn.Module):
    """LayerNorm with the port's parameter names (`scale`, `bias`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class MLP(nn.Module):
    """Stack of Linear + ReLU (children Linear_0, Linear_1, ...)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 final_activation: bool = False):
        super().__init__()
        self.n = len(features)
        self.final_activation = final_activation
        dims = [in_features] + list(features)
        for i in range(self.n):
            self.add_module(f'Linear_{i}', Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'Linear_{i}')(x)
            if i < self.n - 1 or self.final_activation:
                x = F.relu(x)
        return x


class Embedding(nn.Module):
    """Embedding table with an optional always-zero padding row."""

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))
        self.padding_idx = padding_idx

    def forward(self, tokens):
        out = self.embedding[tokens.long()].float()
        if self.padding_idx is not None:
            out = torch.where((tokens == self.padding_idx)[..., None],
                              torch.zeros_like(out), out)
        return out


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_positions: int = 10000):
    """Sinusoidal time embedding."""
    timesteps = timesteps * max_positions
    half_dim = embedding_dim // 2
    emb = np.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
