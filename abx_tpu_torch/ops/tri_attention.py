"""Packed triangle / seq attention: projection + attention in one call.

Counterpart of abx_tpu/ops/tri_attention.py::triangle_attention_packed (the
Pallas TPU kernel): per (batch, row), optional LayerNorm of the raw input,
per-head q/k/v (+ gate) projections, logits + bias + key-mask bias with an
f32 softmax, the attend, x sigmoid(gate), and optionally the out-proj +
bias + residual.  On the card the wrapper runs three launches of this
repository's kernels (`csrc/row_linear.cu`, `csrc/tri_attention.cu`,
`csrc/row_linear.cu`); the source notes there say what bounds each and
how.  The (B, R, H, L, L) logits never reach device memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9


def triangle_attention_packed_plain(x, wq, wk, wv, bias, mask, ln=None,
                                    gate=None, out_proj=None, residual=None):
    """Plain PyTorch version, computed in f32 (as the JAX
    `triangle_attention_packed_reference`, plus the LN / gate / out-proj /
    residual options of the kernel); returns x.dtype."""
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
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('brhqk,brkhd->brqhd', probs, v).reshape(b, r, l, h * d)
    if gate is not None:
        out = out * torch.sigmoid(F.linear(xf, gate[0].float(),
                                           gate[1].float()))
    if out_proj is not None:
        out = (F.linear(out, out_proj[0].float(), out_proj[1].float())
               + residual.float())
    return out.to(x.dtype)


def triangle_attention_packed(x, wq, wk, wv, bias, mask, ln=None, gate=None,
                              out_proj=None, residual=None):
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
    Returns: (B, R, L, H*D), or (B, R, L, C_out) with `out_proj`.
    """
    if not registry.on_device(x):
        return triangle_attention_packed_plain(x, wq, wk, wv, bias, mask, ln,
                                               gate, out_proj, residual)
    if out_proj is not None and residual is None:
        raise ValueError('triangle_attention_packed: out_proj needs the '
                         'residual')
    b, r, l, c = x.shape
    h = bias.shape[1]
    hd = wq.shape[0]
    d = hd // h
    dt = x.dtype
    dev = x.device
    # Fused [q*D^-1/2 | k | v | gate] projection; the query scale is folded
    # into wq here.  Only the gate columns carry a bias.
    w_all = [wq.float() * (d ** -0.5), wk.float(), wv.float()]
    b_all = [torch.zeros(3 * hd, device=dev)]
    if gate is not None:
        w_all.append(gate[0].float())
        b_all.append(gate[1].float())
    w_all = torch.cat(w_all, dim=0).to(dt).contiguous()
    b_all = torch.cat(b_all).contiguous()
    n_proj = w_all.shape[0]
    ln_s = ln_b = None
    if ln is not None:
        ln_s, ln_b = ln[0].float().contiguous(), ln[1].float().contiguous()
    bias_t = bias.to(dt).contiguous()
    maskbias = ((1.0 - mask.float()) * BIG_NEG).contiguous()
    _lib.check_cuda_inputs('triangle_attention_packed', dt, x=x, w_all=w_all,
                           bias=bias_t, residual=residual,
                           f32=dict(b_all=b_all, maskbias=maskbias,
                                    ln_s=ln_s, ln_b=ln_b))
    _lib.require(wk.shape == (hd, c) and wv.shape == (hd, c)
                 and wq.shape == (hd, c) and hd == h * d,
                 'triangle_attention_packed: wq/wk/wv must be (H*D, C)')
    _lib.require(bias.shape == (b, h, l, l) and mask.shape == (b, l),
                 'triangle_attention_packed: bias (B,H,L,L), mask (B,L)')
    _lib.require(ln is None or ln_s.shape == ln_b.shape == (c,),
                 'triangle_attention_packed: LN params must be (C,)')
    _lib.require(n_proj == 3 * hd and b_all.shape == (3 * hd,)
                 or n_proj == 4 * hd and b_all.shape == (4 * hd,),
                 'triangle_attention_packed: gate must be ((H*D, C), (H*D,))')
    lib = _lib.lib()
    s = _lib.stream(x)
    code = _lib.DTYPE_CODE[dt]
    m = b * r * l
    y = torch.empty((m, n_proj), dtype=dt, device=dev)
    _lib.check(lib.abx_row_linear(
        code, x.data_ptr(), m, c, c, _lib.ptr(ln_s), _lib.ptr(ln_b),
        w_all.data_ptr(), b_all.data_ptr(), None, None, y.data_ptr(), n_proj,
        0, 1, 1, s), 'triangle_attention_packed (projection)')
    att = torch.empty((m, hd), dtype=dt, device=dev)
    _lib.check(lib.abx_tri_attention_core(
        code, y.data_ptr(), n_proj, b, r, l, h, d, bias_t.data_ptr(),
        maskbias.data_ptr(), int(gate is not None), att.data_ptr(), s),
        'triangle_attention_packed (attention)')
    if out_proj is None:
        triangle_attention_packed.launches += 1
        return att.reshape(b, r, l, hd)
    wo = out_proj[0].to(dt).contiguous()
    bo = out_proj[1].float().contiguous()
    c_out = wo.shape[0]
    _lib.require(wo.shape == (c_out, hd)
                 and residual.shape == (b, r, l, c_out),
                 'triangle_attention_packed: wo (C_out, H*D), residual '
                 '(B, R, L, C_out)')
    _lib.check_cuda_inputs('triangle_attention_packed', dt, wo=wo,
                           f32=dict(bo=bo))
    out = torch.empty((b, r, l, c_out), dtype=dt, device=dev)
    _lib.check(lib.abx_row_linear(
        code, att.data_ptr(), m, hd, hd, None, None, wo.data_ptr(),
        bo.data_ptr(), residual.data_ptr(), None, out.data_ptr(), c_out, 0,
        1, 1, s), 'triangle_attention_packed (out-proj)')
    triangle_attention_packed.launches += 1
    return out


triangle_attention_packed.launches = 0
