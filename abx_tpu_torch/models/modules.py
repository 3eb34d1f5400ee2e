"""Shared building blocks with AF2 initialization schemes.

Counterpart of abx_tpu/models/modules.py.  Parameters stay float32; each
layer computes in its `dtype` (bf16 for the production trunk), casting the
input and its weights at the call as the JAX package does.  Module and
parameter names follow the flax tree so that `utils/params.py` maps one
onto the other by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

TRUNC_NORMAL_STD_FACTOR = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator) -> None:
    """N(0, std) truncated at 2 std (resampling outside the band)."""
    with torch.no_grad():
        t = torch.randn(w.shape, generator=generator)
        bad = t.abs() > 2.0
        while bad.any():
            t[bad] = torch.randn(int(bad.sum()), generator=generator)
            bad = t.abs() > 2.0
        w.copy_(t * std)


class Linear(nn.Linear):
    """nn.Linear with an AF2 init scheme and a compute dtype.

    The weight is (out, in); `utils/params.py` transposes the flax
    (in, out) kernel into it."""

    def __init__(self, in_features: int, out_features: int,
                 init: str = 'linear', bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init
        self.dtype = dtype

    def reset(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            fan_in = self.in_features
            if self.init in ('gate', 'final'):
                self.weight.zero_()
            elif self.init == 'attn':
                lim = np.sqrt(6.0 / (fan_in + self.out_features))
                self.weight.copy_(torch.rand(self.weight.shape,
                                             generator=generator)
                                  * 2 * lim - lim)
            elif self.init in ('relu', 'linear'):
                scale = 2.0 if self.init == 'relu' else 1.0
                _trunc_normal_(self.weight, float(
                    np.sqrt(scale / fan_in) / TRUNC_NORMAL_STD_FACTOR),
                    generator)
            else:
                raise ValueError(f'unknown init {self.init}')
            if self.bias is not None:
                self.bias.fill_(1.0 if self.init == 'gate' else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def layer_norm(x, scale, bias, eps: float = 1e-5,
               dtype: torch.dtype = torch.float32, two_pass: bool = False):
    """LayerNorm in f32.

    One-pass moments (E[x^2] - E[x]^2, clamped at 0) by default: one read
    of x, the inference form.  `two_pass` takes the variance as
    E[(x - mean)^2], which keeps its precision where |mean| >> std; the
    modules ask for it in training (`self.training`), as the JAX trainer
    traces its loss under `two_pass_layer_norm()`."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    if two_pass:
        var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    else:
        meansq = torch.square(x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(meansq - torch.square(mean), min=0.0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in f32 regardless of compute dtype (params
    `scale`/`bias`, as in the flax tree)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def reset(self, generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps, self.dtype,
                          two_pass=self.training)


class MLP(nn.Module):
    """Stack of Linear+ReLU (flax children Linear_0, Linear_1, ...)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 inits: Sequence[str], final_activation: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(features)
        self.final_activation = final_activation
        dims = [in_features] + list(features)
        for i, init in enumerate(inits):
            self.add_module(f'Linear_{i}', Linear(dims[i], dims[i + 1],
                                                  init=init, dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f'Linear_{i}')(x)
            if i < self.n - 1 or self.final_activation:
                x = F.relu(x)
        return x


class Embedding(nn.Module):
    """Embedding table with an optional always-zero padding row (param
    `embedding`, as in the flax TokenEmbedding)."""

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))
        self.padding_idx = padding_idx
        self.dtype = dtype

    def reset(self, generator) -> None:
        with torch.no_grad():
            self.embedding.copy_(torch.randn(self.embedding.shape,
                                             generator=generator))

    def forward(self, tokens):
        out = self.embedding[tokens.long()].to(self.dtype)
        if self.padding_idx is not None:
            out = torch.where((tokens == self.padding_idx)[..., None],
                              torch.zeros_like(out), out)
        return out


def fused_dense(x, linears: Sequence[Linear], dtype):
    """One matmul over several Linear branches reading the same input;
    equal to the separate matmuls (each output column is its own dot)."""
    w = torch.cat([m.weight.to(dtype) for m in linears], dim=0)
    if any(m.bias is not None for m in linears):
        b = torch.cat([m.bias.to(dtype) if m.bias is not None
                       else torch.zeros(m.out_features, dtype=dtype,
                                        device=x.device) for m in linears])
    else:
        b = None
    y = F.linear(x.to(dtype), w, b)
    return torch.split(y, [m.out_features for m in linears], dim=-1)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A generator whose draws are made for the whole batch of `total`
    rows, of which the caller holds rows [start, stop): a data-parallel
    rank draws the one-process step's dropout masks and keeps its rows."""
    generator: torch.Generator
    start: int
    stop: int
    total: int


def shared_dropout(x, rate: float, generator,
                   broadcast_dim: Optional[int] = None):
    """Dropout whose keep mask is drawn from `generator` (a
    `torch.Generator`, or a `RowShard` of one; on x's device) and, with
    `broadcast_dim`, shared along that axis (AF2 row / column dropout):
    kept values scaled by 1 / (1 - rate).  The callers apply it in
    training only; rate 0 returns x and draws nothing."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in training needs a torch.Generator')
    shape = list(x.shape)
    if broadcast_dim is not None:
        shape[broadcast_dim] = 1
    if isinstance(generator, RowShard):
        if broadcast_dim == 0 or shape[0] != generator.stop - generator.start:
            raise ValueError(f'RowShard rows [{generator.start}, '
                             f'{generator.stop}) for a batch of {shape[0]}')
        keep = torch.rand([generator.total] + shape[1:],
                          generator=generator.generator,
                          device=x.device)[generator.start:generator.stop] \
            < 1.0 - rate
    else:
        keep = torch.rand(shape, generator=generator, device=x.device) \
            < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_positions: int = 10000):
    """Sinusoidal time embedding (reference seqformer.py:49-65)."""
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


def reset_parameters(model: nn.Module, seed: int) -> None:
    """AF2-style random init of every submodule that has a `reset`, from
    one `torch.Generator` seeded with `seed` (CPU, then moved with the
    model).  Parameters owned directly by a module are set by its own
    `reset`."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, 'reset'):
            m.reset(g)
