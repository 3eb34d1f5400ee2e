"""Small tensor utilities of the reference."""

from __future__ import annotations

import torch


def batched_gather(data: torch.Tensor, indices: torch.Tensor,
                   batch_dims: int = 0) -> torch.Tensor:
    """Gather `data` along axis `batch_dims` with per-batch `indices`.

    Leading `batch_dims` axes of `data` and `indices` are shared; the
    result has shape indices.shape + data.shape[batch_dims + 1:].
    """
    indices = indices.long()
    if batch_dims == 0:
        return data[indices]
    lead = data.shape[:batch_dims]
    n = 1
    for s in lead:
        n *= int(s)
    d = data.reshape((n,) + data.shape[batch_dims:])
    idx = indices.reshape((n,) + indices.shape[batch_dims:])
    rows = torch.arange(n, device=data.device).reshape(
        (n,) + (1,) * (idx.dim() - 1))
    out = d[rows, idx]
    return out.reshape(indices.shape + data.shape[batch_dims + 1:])


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True)
                          + eps)
