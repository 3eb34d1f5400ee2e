"""Fused IPA attention: logits + softmax + scalar / point / pair attends.

Counterpart of abx_tpu/ops/ipa_attention.py::ipa_attention (the Pallas TPU
kernel).  On the card this runs `csrc/ipa_attention.cu`; the (B, H, L, L)
logits and probabilities never reach device memory.  The kernel masks keys
only; the module's plain path also masks query rows, so the two agree on
valid query rows.
"""

from __future__ import annotations

import torch

from abx_tpu_torch.ops import _lib, registry

BIG_NEG = -1e9


def ipa_attention_plain(qs, ks, vs, qp, kp, vp, pw, bias, mask, pair):
    """Plain PyTorch version (mirrors ipa_attention_reference)."""
    f = torch.float32
    logits = torch.einsum('bihd,bjhd->bhij', qs.to(f), ks.to(f))
    q2 = torch.sum(torch.square(qp.to(f)), dim=(-1, -2))
    k2 = torch.sum(torch.square(kp.to(f)), dim=(-1, -2))
    cross = torch.einsum('bihpr,bjhpr->bhij', qp.to(f), kp.to(f))
    dist2 = (q2.permute(0, 2, 1)[:, :, :, None]
             + k2.permute(0, 2, 1)[:, :, None, :] - 2.0 * cross)
    logits = logits + pw.to(f)[None, :, None, None] * dist2
    logits = logits + bias.to(f)
    logits = logits + ((1.0 - mask.to(f)) * BIG_NEG)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    dt = pair.dtype
    out_s = torch.einsum('bhij,bjhd->bihd', probs.to(dt), vs.to(dt))
    b, l, h, ds = out_s.shape
    out_p = torch.einsum('bhij,bjhpr->bihpr', probs, vp.to(f))
    out_2d = torch.einsum('bhij,bijc->bihc', probs.to(dt), pair)
    return out_s.reshape(b, l, h * ds), out_p, out_2d.reshape(b, l, -1)


def ipa_attention(qs, ks, vs, qp, kp, vp, pw, bias, mask, pair):
    """Fused IPA attention.

    Args:
        qs: (B, L, H, Ds) scalar queries, already scaled by the scalar
            logit weight.
        ks, vs: (B, L, H, Ds) scalar keys / values.
        qp, kp: (B, L, H, Pq, 3) f32 centred global query / key points.
        vp: (B, L, H, Pv, 3) f32 global value points.
        pw: (H,) f32 point-term weights (-0.5 * w_c * softplus(.)).
        bias: (B, H, L, L) pair bias; mask: (B, L) key mask (1 = valid).
        pair: (B, L, L, C) pair activations, natural layout.
    Returns:
        (out_s (B, L, H*Ds) pair.dtype, out_p (B, L, H, Pv, 3) f32,
         out_2d (B, L, H*C) pair.dtype)
    """
    if not registry.on_device(pair):
        return ipa_attention_plain(qs, ks, vs, qp, kp, vp, pw, bias, mask,
                                   pair)
    b, l, h, ds = qs.shape
    pq, pv = qp.shape[-2], vp.shape[-2]
    c = pair.shape[-1]
    dt = pair.dtype
    f = torch.float32
    _lib.require(c % 16 == 0 and c <= 256,
                 'ipa_attention: pair channels must be a multiple of 16, '
                 'at most 256')
    _lib.require(h <= 16, 'ipa_attention: at most 16 heads (the heads are '
                 'the M dimension of one 16-row pair-attend tile)')
    _lib.require(ks.shape == qs.shape and vs.shape == qs.shape
                 and qp.shape == (b, l, h, pq, 3)
                 and kp.shape == (b, l, h, pq, 3)
                 and vp.shape == (b, l, h, pv, 3)
                 and bias.shape == (b, h, l, l) and mask.shape == (b, l)
                 and pair.shape == (b, l, l, c) and pw.shape == (h,),
                 'ipa_attention: shapes')
    # Fold the per-head point weight: qp and both squared norms carry pw_h,
    # so the in-kernel point term is q2 + k2 - 2 qp.kp.
    pwf = pw.to(f)
    qpf = qp.to(f).reshape(b, l, h, pq * 3)
    kpf = kp.to(f).reshape(b, l, h, pq * 3).contiguous()
    q2 = (torch.sum(qpf * qpf, dim=-1) * pwf).contiguous()
    k2 = (torch.sum(kpf * kpf, dim=-1) * pwf).contiguous()
    qpf = (qpf * pwf[:, None]).contiguous()
    vpf = vp.to(f).reshape(b, l, h, pv * 3).contiguous()
    qs_, ks_, vs_ = (t.to(dt).contiguous() for t in (qs, ks, vs))
    bias_f = bias.to(f).contiguous()
    maskbias = ((1.0 - mask.to(f)) * BIG_NEG).contiguous()
    _lib.check_cuda_inputs('ipa_attention', dt, qs=qs_, ks=ks_, vs=vs_,
                           pair=pair,
                           f32=dict(qp=qpf, kp=kpf, vp=vpf, q2=q2, k2=k2,
                                    bias=bias_f, maskbias=maskbias))
    out_s = torch.empty((b, l, h * ds), dtype=dt, device=pair.device)
    out_p = torch.empty((b, l, h * pv * 3), dtype=f, device=pair.device)
    out_2d = torch.empty((b, l, h * c), dtype=dt, device=pair.device)
    err = _lib.lib().abx_ipa_attention(
        _lib.DTYPE_CODE[dt], qs_.data_ptr(), ks_.data_ptr(), vs_.data_ptr(),
        qpf.data_ptr(), kpf.data_ptr(), vpf.data_ptr(), q2.data_ptr(),
        k2.data_ptr(), bias_f.data_ptr(), maskbias.data_ptr(),
        pair.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
        out_2d.data_ptr(), b, l, h, ds, pq * 3, pv * 3, c,
        _lib.stream(pair))
    _lib.check(err, 'ipa_attention')
    ipa_attention.launches += 1
    return out_s, out_p.reshape(b, l, h, pv, 3), out_2d


ipa_attention.launches = 0
