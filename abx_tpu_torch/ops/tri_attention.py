"""Triangle / seq attention kernels.

Counterparts of three Pallas TPU kernels of abx_tpu/ops/tri_attention.py:
- `triangle_attention_packed`: per (batch, row), optional LayerNorm of the
  raw input, per-head q/k/v (+ gate) projections, logits + bias + key-mask
  bias with an f32 softmax, the attend, x sigmoid(gate), and optionally
  the out-proj + bias + residual.  On the card three launches of this
  repository's kernels (`csrc/row_linear.cu`, `csrc/tri_attention.cu`,
  `csrc/row_linear.cu`).
- `triangle_attention_packed_cols`: the same over the columns of the raw
  natural pair tensor (the ending-node attention: LN, projections, gate;
  no out-proj), in and out in the natural layout.  On the card the
  projection of the natural rows, then the attention core over columns.
- `triangle_attention_fused`: head-major q, k, v (B, R, H, L, D) with an
  f32 bias, all of it in one launch of `csrc/tri_attention.cu`.
The fused projection's weights (the query scale folded in, f32 biases and
LayerNorm params, the out-proj in the compute dtype) come packed by
`pack_projection`, which the module caches (`ops/weight_cache.py`); in bf16
the projection and the out-proj run the Hopper core of
`csrc/row_linear_sm90.cuh`.
The attention of all three runs on the register-resident flash core of
`csrc/flash_attention.cuh`; the source notes there and in
`csrc/tri_attention.cu` say what bounds it and how.  The (B, R, H, L, L)
logits never reach device memory.  With bf16 inputs the packed kernels
take the softmax exponent as the TPU kernels do under
`ABX_TRI_ATTN_BF16_EXP` (default on): exp of the logits minus the row's
final max rounded to bf16, its result rounded to bf16, summed in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9
MAX_HEAD_DIM = 128   # the core's largest compile-time head dim


def softmax_bf16_exp(logits):
    """Softmax over the last axis with the exponent taken as the TPU kernel
    takes it under ABX_TRI_ATTN_BF16_EXP: exp(bf16(s - max)) rounded to
    bf16, then summed and normalised in f32."""
    shifted = logits - logits.amax(-1, keepdim=True)
    e = torch.exp(shifted.to(torch.bfloat16).float()).to(
        torch.bfloat16).float()
    return e / e.sum(-1, keepdim=True)


def _bf16_exp(x) -> bool:
    """Whether the kernels take the bf16 exponent for this input."""
    return x.dtype == torch.bfloat16 and registry.use_tri_attn_bf16_exp()


def triangle_attention_packed_plain(x, wq, wk, wv, bias, mask, ln=None,
                                    gate=None, out_proj=None, residual=None,
                                    bf16_exp: bool = False, packed=None):
    """Plain PyTorch version, computed in f32 (as the JAX
    `triangle_attention_packed_reference`, plus the LN / gate / out-proj /
    residual options of the kernel, and with `bf16_exp` the kernel's bf16
    softmax exponent, `softmax_bf16_exp`); returns x.dtype.  `packed` (the
    kernels' weights) is not used."""
    b, r, l, c = x.shape
    h = bias.shape[1]
    d = wq.shape[0] // h
    xf = x.float()
    if ln is not None:
        xf = layer_norm(xf, ln[0], ln[1])

    def proj(w):
        return F.linear(xf, w.float()).reshape(b, r, l, h, d)
    q, k, v = proj(wq), proj(wk), proj(wv)
    logits = torch.einsum('brqhd,brkhd->brhqk', q * (d ** -0.5), k)
    logits = logits + bias[:, None].float()
    maskbias = (1.0 - mask.float()) * BIG_NEG
    logits = logits + maskbias[:, None, None, None, :]
    probs = (softmax_bf16_exp(logits) if bf16_exp
             else torch.softmax(logits, dim=-1))
    out = torch.einsum('brhqk,brkhd->brqhd', probs, v).reshape(b, r, l, h * d)
    if gate is not None:
        out = out * torch.sigmoid(F.linear(xf, gate[0].float(),
                                           gate[1].float()))
    if out_proj is not None:
        out = (F.linear(out, out_proj[0].float(), out_proj[1].float())
               + residual.float())
    return out.to(x.dtype)


def tri_attention_core_plain(y, shape, bias, mask, gate: bool,
                             bf16_exp: bool = False, columns: bool = False):
    """Plain PyTorch version of the attention core of the packed kernels,
    in f32: y (B*R*L, n) holds the projection rows [q | k | v | gate?] (the
    query scale folded into q) in the natural order of a (B, R, L) tensor
    (R == L for columns, whose column i, position l is row (b*L + l)*L +
    i); bias (B, H, L, L); mask (B, L), 1 = valid key.  Returns the gated
    attention output, (B*R*L, H*D) in the order of y's rows, in y.dtype."""
    b, r, l, h, d = shape
    hd = h * d
    yf = y.float().reshape(b, r, l, -1)
    if columns:
        yf = yf.transpose(1, 2)
    q, k, v = (yf[..., i * hd:(i + 1) * hd].reshape(b, r, l, h, d)
               for i in range(3))
    logits = torch.einsum('brqhd,brkhd->brhqk', q, k)
    maskbias = (1.0 - mask.float()) * BIG_NEG
    logits = (logits + bias[:, None].float()
              + maskbias[:, None, None, None, :])
    probs = (softmax_bf16_exp(logits) if bf16_exp
             else torch.softmax(logits, dim=-1))
    out = torch.einsum('brhqk,brkhd->brqhd', probs, v).reshape(b, r, l, hd)
    if gate:
        out = out * torch.sigmoid(yf[..., 3 * hd:4 * hd])
    if columns:
        out = out.transpose(1, 2)
    return out.reshape(b * r * l, hd).to(y.dtype)


def tri_attention_core(y, shape, bias, mask, gate: bool,
                       bf16_exp: bool = False, columns: bool = False):
    """The attention core of `triangle_attention_packed` (rows) and
    `triangle_attention_packed_cols` (columns) on ready projection rows:
    one launch of `csrc/tri_attention.cu` on the card (counted by those
    wrappers, not here), the plain version on the CPU.  Arguments as
    `tri_attention_core_plain`; bias in y.dtype, mask f32, both
    contiguous; D <= MAX_HEAD_DIM.  The bf16 exponent applies to bf16
    inputs only."""
    bf16_exp = bf16_exp and y.dtype == torch.bfloat16
    if not registry.on_device(y):
        return tri_attention_core_plain(y, shape, bias, mask, gate,
                                        bf16_exp, columns)
    _lib.refuse_autograd('tri_attention_core', y, bias)
    b, r, l, h, d = shape
    dt = y.dtype
    n = y.shape[1]
    _lib.check_cuda_inputs('tri_attention_core', dt, y=y, bias=bias,
                           f32=dict(mask=mask))
    _lib.require(0 < d <= MAX_HEAD_DIM,
                 f'tri_attention_core: head dim {d}, the kernel takes 1 to '
                 f'{MAX_HEAD_DIM}')
    _lib.require(y.shape[0] == b * r * l and n >= (4 if gate else 3) * h * d
                 and bias.shape == (b, h, l, l) and mask.shape == (b, l)
                 and (r == l or not columns),
                 'tri_attention_core: y (B*R*L, >= 3 or 4 H*D), bias '
                 '(B, H, L, L), mask (B, L)')
    out = torch.empty((b * r * l, h * d), dtype=dt, device=y.device)
    _lib.check(_lib.lib().abx_tri_attention_core(
        _lib.DTYPE_CODE[dt], y.data_ptr(), n, b, r, l, h, d, bias.data_ptr(),
        mask.data_ptr(), int(gate), int(bf16_exp), int(columns),
        out.data_ptr(), _lib.stream(y)), 'tri_attention_core')
    return out


class ProjPack(NamedTuple):
    """The triangle attention's weights as its kernels take them: the fused
    [q * D^-1/2 | k | v (| gate)] projection (n, C) in the compute dtype and
    its f32 bias (zero but for the gate columns), the f32 LayerNorm params
    (None without), and the out-proj weight in the compute dtype with its
    f32 bias (None without)."""
    w_all: torch.Tensor
    b_all: torch.Tensor
    ln_s: torch.Tensor | None
    ln_b: torch.Tensor | None
    wo: torch.Tensor | None
    bo: torch.Tensor | None


def pack_projection(wq, wk, wv, d: int, dtype, ln=None, gate=None,
                    out_proj=None) -> ProjPack:
    """ProjPack of (H*D, C) q / k / v weights of head dim `d` (the query
    scale d^-1/2 folded into wq), the optional LayerNorm params, gate
    (w, b) and out-proj (w, b), for the compute dtype `dtype`."""
    hd = wq.shape[0]
    w_all = [wq.float() * (d ** -0.5), wk.float(), wv.float()]
    b_all = [torch.zeros(3 * hd, device=wq.device)]
    if gate is not None:
        w_all.append(gate[0].float())
        b_all.append(gate[1].float())
    ln_s = ln_b = wo = bo = None
    if ln is not None:
        ln_s, ln_b = (p.float().contiguous() for p in ln)
    if out_proj is not None:
        wo = out_proj[0].to(dtype).contiguous()
        bo = out_proj[1].float().contiguous()
    return ProjPack(torch.cat(w_all).to(dtype).contiguous(),
                    torch.cat(b_all).contiguous(), ln_s, ln_b, wo, bo)


def _project_and_attend(name, x, wq, wk, wv, bias, mask, ln, gate,
                        bf16_exp: bool, columns: bool, packed=None):
    """The kernels shared by the packed rows and columns: LN + the fused
    [q*D^-1/2 | k | v | gate] projection of the natural rows of x
    (`csrc/row_linear.cu`), then the attention core over rows or columns
    (`tri_attention_core`).  Returns the gated attention output,
    (B*R*L, H*D) in the order of x's rows."""
    b, r, l, c = x.shape
    h = bias.shape[1]
    hd = wq.shape[0]
    d = hd // h
    dt = x.dtype
    if packed is None:
        packed = pack_projection(wq, wk, wv, d, dt, ln=ln, gate=gate)
    w_all, b_all = packed.w_all, packed.b_all
    ln_s, ln_b = packed.ln_s, packed.ln_b
    n_proj = w_all.shape[0]
    bias_t = bias if bias.dtype == dt and bias.is_contiguous() else (
        bias.to(dt).contiguous())
    mask_f = mask if mask.dtype == torch.float32 else mask.float()
    _lib.check_cuda_inputs(name, dt, x=x, w_all=w_all, bias=bias_t,
                           f32=dict(b_all=b_all, mask=mask_f,
                                    ln_s=ln_s, ln_b=ln_b))
    _lib.require(wk.shape == (hd, c) and wv.shape == (hd, c)
                 and wq.shape == (hd, c) and hd == h * d,
                 f'{name}: wq/wk/wv must be (H*D, C)')
    _lib.require(bias.shape == (b, h, l, l) and mask.shape == (b, l)
                 and (r == l or not columns),
                 f'{name}: bias (B,H,L,L), mask (B,L)')
    _lib.require((ln is None) == (ln_s is None)
                 and (ln_s is None or ln_s.shape == ln_b.shape == (c,)),
                 f'{name}: LN params must be (C,)')
    _lib.require(w_all.shape[1] == c and b_all.shape == (n_proj,)
                 and n_proj == (3 if gate is None else 4) * hd,
                 f'{name}: gate must be ((H*D, C), (H*D,))')
    m = b * r * l
    y = torch.empty((m, n_proj), dtype=dt, device=x.device)
    _lib.check(_lib.lib().abx_row_linear(
        _lib.DTYPE_CODE[dt], x.data_ptr(), m, c, c, _lib.ptr(ln_s),
        _lib.ptr(ln_b), w_all.data_ptr(), b_all.data_ptr(), None, None,
        y.data_ptr(), n_proj, 0, 1, 1, _lib.stream(x)),
        f'{name} (projection)')
    return tri_attention_core(y, (b, r, l, h, d), bias_t, mask_f,
                              gate is not None, bf16_exp, columns)


def triangle_attention_packed(x, wq, wk, wv, bias, mask, ln=None, gate=None,
                              out_proj=None, residual=None,
                              packed: ProjPack | None = None):
    """Layout-native fused attention over the rows of x.

    Args:
        x: (B, R, L, C) activations (RAW when `ln` is given, else post-LN).
        wq, wk, wv: (H*D, C) projections (nn.Linear layout, head-major
            column blocks).
        bias: (B, H, L, L) attention bias, shared across rows.
        mask: (B, L) key mask (1 = valid).
        ln: optional (scale, bias) LayerNorm params, applied in-kernel.
        gate: optional (wg (H*D, C), bg (H*D,)): out *= sigmoid(x wg^T + bg).
        out_proj: optional (wo (C_out, H*D), bo (C_out,)); requires
            `residual` (B, R, L, C_out), which is added in the epilogue.
        packed: these weights as `pack_projection` packs them for x.dtype
            (a module caches it); packed here when None.
    Returns: (B, R, L, H*D), or (B, R, L, C_out) with `out_proj`.
    """
    bf16_exp = _bf16_exp(x)
    if not registry.on_device(x):
        return triangle_attention_packed_plain(x, wq, wk, wv, bias, mask, ln,
                                               gate, out_proj, residual,
                                               bf16_exp)
    _lib.refuse_autograd('triangle_attention_packed', x, wq, wk, wv, bias,
                         residual, *(ln or ()), *(gate or ()),
                         *(out_proj or ()))
    b, r, l, c = x.shape
    hd = wq.shape[0]
    dt = x.dtype
    if packed is None:
        packed = pack_projection(wq, wk, wv, hd // bias.shape[1], dt, ln=ln,
                                 gate=gate, out_proj=out_proj)
    if out_proj is not None:
        wo, bo = packed.wo, packed.bo
        c_out = wo.shape[0]
        _lib.require(residual is not None,
                     'triangle_attention_packed: out_proj needs the residual')
        _lib.check_cuda_inputs('triangle_attention_packed', dt, wo=wo,
                               residual=residual, f32=dict(bo=bo))
        _lib.require(wo.shape == (c_out, hd)
                     and residual.shape == (b, r, l, c_out),
                     'triangle_attention_packed: wo (C_out, H*D), residual '
                     '(B, R, L, C_out)')
    att = _project_and_attend('triangle_attention_packed', x, wq, wk, wv,
                              bias, mask, ln, gate, bf16_exp, False, packed)
    if out_proj is None:
        triangle_attention_packed.launches += 1
        return att.reshape(b, r, l, hd)
    out = torch.empty((b, r, l, c_out), dtype=dt, device=x.device)
    _lib.check(_lib.lib().abx_row_linear(
        _lib.DTYPE_CODE[dt], att.data_ptr(), b * r * l, hd, hd, None, None,
        wo.data_ptr(), bo.data_ptr(), residual.data_ptr(), None,
        out.data_ptr(), c_out, 0, 1, 1, _lib.stream(x)),
        'triangle_attention_packed (out-proj)')
    triangle_attention_packed.launches += 1
    return out


triangle_attention_packed.launches = 0


def triangle_attention_packed_cols_plain(x, ln_scale, ln_bias, wq, wk, wv,
                                         wg, bg, bias, mask,
                                         bf16_exp: bool = False,
                                         packed=None):
    """Plain PyTorch version (as the JAX
    `triangle_attention_packed_cols_reference`): the packed plain version
    on the transposed pair, transposed back; returns x.dtype.  `packed` is
    not used."""
    out = triangle_attention_packed_plain(
        x.transpose(1, 2), wq, wk, wv, bias, mask, ln=(ln_scale, ln_bias),
        gate=(wg, bg), bf16_exp=bf16_exp)
    return out.transpose(1, 2).contiguous()


def triangle_attention_packed_cols(x, ln_scale, ln_bias, wq, wk, wv, wg, bg,
                                   bias, mask,
                                   packed: ProjPack | None = None):
    """Ending-node (per-column) attention on the RAW natural pair tensor:
    LN + [q|k|v|gate] projections + attention along the row axis + gate,
    natural layout in and out.

    Args:
        x: (B, L, L, C) raw pair activations.
        ln_scale, ln_bias: (C,) input LayerNorm params.
        wq, wk, wv, wg: (H*D, C) projections (nn.Linear layout); bg: (H*D,)
            gate bias.
        bias: (B, H, L, L) bias of the transposed node, bias[b, h, q, k].
        mask: (B, L) key mask over the row axis (1 = valid).
        packed: these weights as `pack_projection` packs them for x.dtype;
            packed here when None.
    Returns: (B, L, L, H*D) in x.dtype; out[b, l, i] is the attention
        output of query l in column i.
    """
    bf16_exp = _bf16_exp(x)
    if not registry.on_device(x):
        return triangle_attention_packed_cols_plain(
            x, ln_scale, ln_bias, wq, wk, wv, wg, bg, bias, mask, bf16_exp)
    _lib.refuse_autograd('triangle_attention_packed_cols', x, ln_scale,
                         ln_bias, wq, wk, wv, wg, bg, bias)
    b, l, _, c = x.shape
    att = _project_and_attend('triangle_attention_packed_cols', x, wq, wk,
                              wv, bias, mask, (ln_scale, ln_bias), (wg, bg),
                              bf16_exp, True, packed)
    triangle_attention_packed_cols.launches += 1
    return att.reshape(b, l, l, wq.shape[0])


triangle_attention_packed_cols.launches = 0


def triangle_attention_fused_plain(q, k, v, bias, mask):
    """Plain PyTorch version (as the JAX `triangle_attention_reference` and
    its Pallas kernel): the f32-upcast q scaled by D^-1/2, logits + bias +
    key-mask bias and the softmax in f32, the attend in f32; returns
    q.dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('brhqd,brhkd->brhqk', q.float() * scale,
                          k.float())
    maskbias = (1.0 - mask.float()) * BIG_NEG
    logits = (logits + bias[:, None].float()
              + maskbias[:, None, None, None, :])
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum('brhqk,brhkd->brhqd', probs, v.float()).to(q.dtype)


def triangle_attention_fused(q, k, v, bias, mask):
    """Row-batched attention on head-major operands.

    Args:
        q, k, v: (B, R, H, L, D), contiguous: rows R attend over length L
            per head.
        bias: (B, H, L, L), shared by the rows; read in f32.
        mask: (B, L) key mask (1 = valid).
    Returns: (B, R, H, L, D) in q.dtype.
    """
    if not registry.on_device(q):
        return triangle_attention_fused_plain(q, k, v, bias, mask)
    _lib.refuse_autograd('triangle_attention_fused', q, k, v, bias)
    b, r, h, l, d = q.shape
    dt = q.dtype
    bias_f = bias.float().contiguous()
    mask_f = mask.float().contiguous()
    _lib.check_cuda_inputs('triangle_attention_fused', dt, q=q, k=k, v=v,
                           f32=dict(bias=bias_f, mask=mask_f))
    _lib.require(k.shape == v.shape == q.shape
                 and bias.shape == (b, h, l, l) and mask.shape == (b, l)
                 and 0 < d <= MAX_HEAD_DIM,
                 'triangle_attention_fused: q, k, v (B, R, H, L, D), bias '
                 f'(B, H, L, L), mask (B, L), D <= {MAX_HEAD_DIM}')
    out = torch.empty_like(q)
    _lib.check(_lib.lib().abx_triangle_attention_fused(
        _lib.DTYPE_CODE[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_f.data_ptr(), mask_f.data_ptr(), out.data_ptr(), b, r, h, l, d,
        _lib.stream(q)), 'triangle_attention_fused')
    triangle_attention_fused.launches += 1
    return out


triangle_attention_fused.launches = 0
