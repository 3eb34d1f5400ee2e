"""Kernel dispatch switches for the ported Hopper kernels.

The same `ABX_*` environment flags and defaults as `abx_tpu/ops/registry.py`
for every kernel route of the model (one exception, `ABX_FUSED_ESM_ATTN`,
says why).  Where the JAX package asks `jax.default_backend() == 'tpu'`,
the port asks `on_device(tensor)`: a kernel route is taken only for
tensors that live on a CUDA device.  The defaults were chosen by TPU
measurements; which suit the H100 waits for the port's benchmark.
"""

from __future__ import annotations

import os

import torch


def on_device(t: torch.Tensor) -> bool:
    """True when `t` lives on the card, i.e. the hand-written kernels apply.

    The predicate behind both decisions: a module takes its kernel route
    (`kernel_route`, in eval mode), and a kernel wrapper launches its
    kernel rather than its plain version.  Tests force the module routes
    on the CPU by patching it and swapping the wrappers for their plain
    versions."""
    return t.is_cuda


def kernel_route(module: torch.nn.Module, t: torch.Tensor) -> bool:
    """A model module may take its kernel route: in eval mode (the JAX
    package's `deterministic=True`; the kernels have no backward) and on
    the card."""
    return not module.training and on_device(t)


def use_fused_tri_attention() -> bool:
    """Packed triangle attention (`ops/tri_attention.py`)."""
    return os.environ.get('ABX_FUSED_TRI_ATTN', '1') == '1'


def use_tri_attn_ln_fold() -> bool:
    """Input LayerNorm + sigmoid gate + out-proj + residual folded into the
    packed triangle-attention kernel; the bias comes from `pair_bias_proj`
    in (B, H, L, L) layout."""
    return os.environ.get('ABX_TRI_ATTN_LN_FOLD', '1') == '1'


def use_packed_seq_attn() -> bool:
    """Seq-track attention through the packed kernel at one row per batch
    element (LN + per-head q/k/v/gate projection + biased softmax + gate +
    out-proj + residual)."""
    return os.environ.get('ABX_PACKED_SEQ_ATTN', '1') == '1'


def use_tri_attn_bf16_exp() -> bool:
    """bf16 inputs of the packed triangle / seq attention (and of its
    column variant) take the softmax exponent the TPU kernel's way:
    exp(bf16(s - m)) rounded to bf16, summed and normalised in f32."""
    return os.environ.get('ABX_TRI_ATTN_BF16_EXP', '1') == '1'


def use_fused_pair_bias() -> bool:
    """Seq-attention pair bias: LN -> C->H projection in one kernel."""
    return os.environ.get('ABX_FUSED_PAIR_BIAS', '1') == '1'


def use_fused_transition() -> bool:
    """Pair transition: LN -> C->4C -> ReLU -> 4C->C -> +residual in one
    kernel; the 4C intermediate never reaches device memory."""
    return os.environ.get('ABX_FUSED_TRANSITION', '1') == '1'


def use_fused_trimult() -> bool:
    """Triangle multiplication pre block (LN -> fused five-way projection
    -> gating and pair mask) and post block (LN -> C_int->C -> x sigmoid(
    final gate) -> +residual) as kernels around the contraction."""
    return os.environ.get('ABX_FUSED_TRIMULT', '1') == '1'


def use_fused_recycle_embed() -> bool:
    """Recycled pair input (concat(static pair, t) + LN(prev_pair) +
    distogram-bin embedding) assembled in one kernel."""
    return os.environ.get('ABX_FUSED_RECYCLE', '1') == '1'


def use_fused_ipa_attention() -> bool:
    """IPA logits + softmax + scalar/point/pair attends in one kernel; the
    (B, H, L, L) logits and probabilities never reach device memory."""
    return os.environ.get('ABX_FUSED_IPA_ATTN', '1') == '1'


def use_fused_esm_attention() -> bool:
    """ESM2 self-attention through the hand-written kernel
    (`ops/esm_attention.py`); the (B, H, L, L) f32 logits never reach
    device memory.

    Default ON in the port, where the JAX package defaults it off.  Its
    default was a TPU v5e measurement of the per-(batch, head) grid's
    overhead, which says nothing about the H100; and with the flag off the
    card's ESM path would run the plain einsum attention, which the port's
    main path may not.  Checked before `use_flash_esm`, as in
    `abx_tpu/models/esm.py`: fused -> flash -> plain."""
    return os.environ.get('ABX_FUSED_ESM_ATTN', '1') == '1'


def use_flash_esm() -> bool:
    """ESM2 attention through `ops/esm_attention.py::esm_flash_attention`,
    the hand-written segment-masked flash kernel (its plain version on the
    CPU): the counterpart of the JAX package's `_esm_flash_attention`,
    which calls JAX's stock TPU flash kernel with segment ids.  A padded
    query attends to the padded keys only, so the padded rows differ from
    `esm_attention`'s; the valid rows agree.  Default off, and only taken
    with `ABX_FUSED_ESM_ATTN=0`."""
    return os.environ.get('ABX_FLASH_ESM', '0') == '1'


def use_pallas_triangle() -> bool:
    """Triangle-multiplication contraction through the hand-written kernel
    (`ops/triangle.py::triangle_multiply_kernel`) instead of the einsum.
    Default off, as in the JAX package."""
    return os.environ.get('ABX_PALLAS_TRIANGLE', '0') == '1'


def use_ipa_attend_kernel() -> bool:
    """IPA attend-over-pair through its kernel (`ops/ipa_attend.py`) on the
    IPA's non-fused route (`ABX_FUSED_IPA_ATTN=0`)."""
    return os.environ.get('ABX_IPA_ATTEND', '1') == '1'


def use_gate_proj_kernel() -> bool:
    """Triangle-attention epilogue (sigmoid gate -> out-proj -> +residual)
    in one kernel (`ops/gate_proj.py`) on the route without the LN-fold
    (`ABX_TRI_ATTN_LN_FOLD=0`).  Default off, as in the JAX package."""
    return os.environ.get('ABX_GATE_PROJ_KERNEL', '0') == '1'


def use_trimult_gatefold() -> bool:
    """Triangle multiplication with the final gate recomputed inside the
    post block from the residual (`tri_mult_pre(emit_fgate=False)` +
    `tri_mult_post_gatefold`): the (B, L, L, C) gate never reaches device
    memory.  Default off, as in the JAX package."""
    return os.environ.get('ABX_TRIMULT_GATEFOLD', '0') == '1'


def use_trimult_c_major() -> bool:
    """Channel-major triangle-multiplication data path: pre emits left and
    right as (B, nc, L, L), the contraction is a batched matrix product on
    that layout and post reads its input channel-major.  Taken before
    `ABX_TRIMULT_GATEFOLD`, and not with `ABX_PALLAS_TRIANGLE`, as in the
    JAX package.  Default off."""
    return os.environ.get('ABX_TRIMULT_C_MAJOR', '0') == '1'
