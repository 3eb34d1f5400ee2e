"""Triangle-multiplication contraction (plain batched GEMM).

Counterpart of `abx_tpu/ops/triangle.py::triangle_multiply_einsum`, the
einsum the JAX package leaves to XLA on its main path (its Pallas variant,
`triangle_multiply_pallas`, is off by default and not ported yet):
    per_row:    out[b,i,j,c] = sum_k left[b,i,k,c] * right[b,j,k,c]
    per_column: out[b,i,j,c] = sum_k left[b,k,i,c] * right[b,k,j,c]
"""

from __future__ import annotations

import torch


def triangle_multiply(left, right, per_row: bool = True):
    if per_row:
        return torch.einsum('bikc,bjkc->bijc', left, right)
    return torch.einsum('bkic,bkjc->bijc', left, right)
