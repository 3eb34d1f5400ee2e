"""Fused IPA attention: logits + softmax + scalar / point / pair attends.

Counterpart of abx_tpu/ops/ipa_attention.py::ipa_attention (the Pallas TPU
kernel).  On the card this is one launch of `csrc/ipa_attention.cu`, which
reads the module's tensors where they lie (strided q / k / v and points,
the bias in its own dtype and layout, the (B, L) mask) and folds the point
weight itself; the (B, H, L, L) logits and probabilities never reach
device memory.  The kernel masks keys only; the module's plain path also
masks query rows, so the two agree on valid query rows.
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
        The scalar attend takes p rounded to pair.dtype, the point attend
        f32 p, as the TPU kernel does.
    Returns:
        (out_s (B, L, H*Ds) pair.dtype, out_p (B, L, H, Pv, 3) f32,
         out_2d (B, L, H*C) pair.dtype)
    """
    if not registry.on_device(pair):
        return ipa_attention_plain(qs, ks, vs, qp, kp, vp, pw, bias, mask,
                                   pair)
    _lib.refuse_autograd('ipa_attention', qs, ks, vs, qp, kp, vp, pw, bias,
                         pair)
    b, l, h, ds = qs.shape
    pq, pv = qp.shape[-2], vp.shape[-2]
    c = pair.shape[-1]
    dt = pair.dtype
    _lib.require(c % 16 == 0 and c <= 256,
                 'ipa_attention: pair channels must be a multiple of 16, '
                 'at most 256')
    _lib.require(h <= 16, 'ipa_attention: at most 16 heads (the heads are '
                 'the M dimension of one 16-row pair-attend tile)')
    _lib.require(ds % 16 == 0 and ds <= 32,
                 'ipa_attention: scalar dims must be 16 or 32 (k16 steps of '
                 'the logits)')
    _lib.require(pq <= 16 and pv <= 16,
                 'ipa_attention: at most 16 query / value points a head')
    _lib.require(ks.shape == qs.shape and vs.shape == qs.shape
                 and qp.shape == (b, l, h, pq, 3)
                 and kp.shape == (b, l, h, pq, 3)
                 and vp.shape == (b, l, h, pv, 3)
                 and bias.shape == (b, h, l, l) and mask.shape == (b, l)
                 and pair.shape == (b, l, l, c) and pw.shape == (h,),
                 'ipa_attention: shapes')
    f = torch.float32
    qs, ks, vs = (_rows(t, dt, 1) for t in (qs, ks, vs))
    qp, kp, vp = (_rows(t, f, 2) for t in (qp, kp, vp))
    if bias.dtype not in (dt, f):
        bias = bias.to(f)
    pw = pw.to(f).contiguous()
    mask = mask.to(f).contiguous()
    _lib.check_cuda_inputs('ipa_attention', dt, pair=pair,
                           f32=dict(pw=pw, mask=mask))
    _lib.require(all(t.is_cuda for t in (qs, ks, vs, qp, kp, vp, bias)),
                 'ipa_attention: inputs must be on the card')
    out_s = torch.empty((b, l, h * ds), dtype=dt, device=pair.device)
    out_p = torch.empty((b, l, h * pv * 3), dtype=f, device=pair.device)
    out_2d = torch.empty((b, l, h * c), dtype=dt, device=pair.device)
    err = _lib.lib().abx_ipa_attention(
        _lib.DTYPE_CODE[dt], *_ptr3(qs), *_ptr3(ks), *_ptr3(vs),
        *_ptr3(qp), *_ptr3(kp), *_ptr3(vp), pw.data_ptr(),
        bias.data_ptr(), *bias.stride(), int(bias.dtype == f),
        mask.data_ptr(), pair.data_ptr(), out_s.data_ptr(),
        out_p.data_ptr(), out_2d.data_ptr(), b, l, h, ds, pq * 3, pv * 3, c,
        _lib.stream(pair))
    _lib.check(err, 'ipa_attention')
    ipa_attention.launches += 1
    return out_s, out_p.reshape(b, l, h, pv, 3), out_2d


def _rows(t, dtype, inner: int):
    """t (B, L, H, ...) in `dtype` with its `inner` last axes one
    contiguous run (a view where it already is: the module's k / v column
    blocks and the value points' slice need no copy)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    run = 1
    for size, stride in zip(reversed(t.shape[-inner:]),
                            reversed(t.stride()[-inner:])):
        if size > 1 and stride != run:
            return t.contiguous()
        run *= size
    return t


def _ptr3(t):
    """Pointer and (batch, position, head) element strides."""
    return (t.data_ptr(),) + tuple(t.stride()[:3])


ipa_attention.launches = 0
