"""Triangle-multiplication contraction.

Counterpart of `abx_tpu/ops/triangle.py`:
    per_row:    out[b,i,j,c] = sum_k left[b,i,k,c] * right[b,j,k,c]
    per_column: out[b,i,j,c] = sum_k left[b,k,i,c] * right[b,k,j,c]
`triangle_multiply` dispatches as the JAX package's does: to the kernel
(`triangle_multiply_kernel`, the counterpart of `triangle_multiply_pallas`,
on the card `csrc/triangle.cu`, which builds its tensor-core fragments
from the 16-byte channel vectors as they lie) when `use_pallas` is set
(the callers pass `ABX_PALLAS_TRIANGLE`) and the tensors live on the card,
and to the einsum (`triangle_multiply_einsum`, a batched GEMM) otherwise.
`triangle_multiply_c_major` is the contraction on the channel-major layout
(`abx_tpu/ops/triangle.py::triangle_multiply_c_major`, an einsum that XLA
computes outside any Pallas kernel): a batched matrix product over B * C,
cuBLAS on the card, on strided views with no copies.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.ops import _lib, registry


def triangle_multiply_einsum(left, right, per_row: bool = True):
    """Plain version: the contraction as one einsum."""
    if per_row:
        return torch.einsum('bikc,bjkc->bijc', left, right)
    return torch.einsum('bkic,bkjc->bijc', left, right)


def triangle_multiply_c_major(left, right, per_row: bool = True):
    """The contraction with the channels in front of the positions:
        per_row:    out[b,c,i,j] = sum_k left[b,c,i,k] * right[b,c,j,k]
        per_column: out[b,c,i,j] = sum_k left[b,c,k,i] * right[b,c,k,j]

    Args:
        left, right: (B, C, L, L), same dtype, contiguous (as
            `tri_mult_pre(c_major=True)` emits them).
    Returns: (B, C, L, L), the input layout of
        `tri_mult_post(y_c_major=True)`.
    """
    b, c, l, _ = left.shape
    lt, rt = left.reshape(b * c, l, l), right.reshape(b * c, l, l)
    # The transposes are strided views: the matrix product reads them as
    # transposed operands, so no copy is made.
    out = (torch.matmul(lt, rt.transpose(-1, -2)) if per_row
           else torch.matmul(lt.transpose(-1, -2), rt))
    return out.reshape(b, c, l, l)


def triangle_multiply_kernel(left, right, per_row: bool = True):
    """The contraction in one kernel that reads and writes the natural
    (B, L, L, C) layout: no transposes in device memory.

    Args:
        left, right: (B, L, L, C), same dtype.
    Returns: (B, L, L, C) in that dtype.
    """
    if not registry.on_device(left):
        return triangle_multiply_einsum(left, right, per_row)
    _lib.refuse_autograd('triangle_multiply', left, right)
    b, l, l2, c = left.shape
    dt = left.dtype
    left, right = left.contiguous(), right.contiguous()
    _lib.check_cuda_inputs('triangle_multiply', dt, left=left, right=right)
    _lib.require(l == l2 and right.shape == left.shape,
                 'triangle_multiply: left and right (B, L, L, C)')
    _lib.require(left.data_ptr() % 16 == 0 and right.data_ptr() % 16 == 0,
                 'triangle_multiply: left and right must be 16-byte aligned')
    # The kernel copies 16-byte channel vectors: pad C up to a whole vector
    # (zeros) where it is not one; the output keeps C.
    vec = 16 // left.element_size()
    cs = -(-c // vec) * vec
    if cs != c:
        left, right = (torch.nn.functional.pad(x, (0, cs - c))
                       for x in (left, right))
    out = torch.empty((b, l, l, c), dtype=dt, device=left.device)
    err = _lib.lib().abx_triangle_multiply(
        _lib.DTYPE_CODE[dt], left.data_ptr(), right.data_ptr(),
        out.data_ptr(), b, l, c, cs, int(per_row), _lib.stream(left))
    _lib.check(err, 'triangle_multiply')
    triangle_multiply_kernel.launches += 1
    return out


triangle_multiply_kernel.launches = 0


def triangle_multiply(left, right, per_row: bool = True,
                      use_pallas: bool = False):
    """Dispatch: the kernel on the card when `use_pallas`, the einsum
    otherwise."""
    if use_pallas and registry.on_device(left):
        return triangle_multiply_kernel(left, right, per_row)
    return triangle_multiply_einsum(left, right, per_row)
