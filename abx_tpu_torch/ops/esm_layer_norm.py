"""ESM2's LayerNorm in eval mode as one kernel.

The JAX package has no Pallas kernel for it: on the TPU, XLA fuses
`modules.layer_norm` (one-pass f32 moments, the inference form) into one
read of x and one write, which is why `abx_tpu/models/esm.py::
_esm_layer_norm` takes that form.  Eager PyTorch runs the same function as
14 launches, each a full pass over the activations.  `esm_layer_norm` is
that function with its cast to the output dtype folded in: on the card it
launches `csrc/esm_layer_norm.cu` (one read of x, one write of the output;
see the source note for what bounds it), on the CPU it is its plain
version.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry

MAX_DIM = 5120   # ESM2 15B's width, the kernel's largest


def esm_layer_norm_plain(x, weight, bias, eps: float, out_dtype):
    """Plain PyTorch version: `modules.layer_norm` (f32 one-pass moments,
    max(var, 0)) rounded once to `out_dtype`, bit for bit
    `layer_norm(x, weight, bias, eps).to(out_dtype)`."""
    return layer_norm(x, weight, bias, eps, dtype=out_dtype)


def esm_layer_norm(x, weight, bias, eps: float, out_dtype):
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last axis, in
    f32, rounded once to `out_dtype`.

    Args:
        x: (..., D), contiguous; D a multiple of 8 up to MAX_DIM.
        weight, bias: (D,), contiguous.
        eps: added to the variance.
        out_dtype: the output's dtype.
    Returns: x's shape in `out_dtype`.  On a CPU tensor it is the plain
    version; on the card it launches the kernel, which takes x, weight,
    bias and the output in one dtype, float32 or bfloat16 (as an ESM2
    module holds its parameters and computes), or raises.
    """
    if not registry.on_device(x):
        return esm_layer_norm_plain(x, weight, bias, eps, out_dtype)
    _lib.refuse_autograd('esm_layer_norm', x, weight, bias)
    d = x.shape[-1]
    ok = (d % 8 == 0 and 0 < d <= MAX_DIM and x.dtype in _lib.DTYPE_CODE
          and weight.dtype == bias.dtype == out_dtype == x.dtype
          and weight.shape == bias.shape == (d,))
    for t in (x, weight, bias):
        ok = ok and t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0
    if not ok:
        raise ValueError(
            'esm_layer_norm: the kernel takes a contiguous CUDA x (..., D) '
            'with D a multiple of 8 up to '
            f'{MAX_DIM}, contiguous CUDA weight and bias (D,), 16-byte '
            'aligned, and an out_dtype, all in one dtype, float32 or '
            'bfloat16; got '
            + '; '.join(f'{n} {t.dtype} {tuple(t.shape)} on {t.device}'
                        for n, t in (('x', x), ('weight', weight),
                                     ('bias', bias)))
            + f'; out_dtype {out_dtype}')
    out = torch.empty_like(x)
    _lib.check(_lib.lib().abx_esm_layer_norm(
        _lib.DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
        _lib.stream(x)), 'esm_layer_norm')
    esm_layer_norm.launches += 1
    return out


esm_layer_norm.launches = 0
