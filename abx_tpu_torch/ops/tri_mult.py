"""Fused triangle-multiplication pre and post blocks.

Counterparts of abx_tpu/ops/tri_mult.py::tri_mult_pre, ::tri_mult_post and
::tri_mult_post_gatefold (Pallas TPU kernels): pre with or without the
final gate (`emit_fgate`), its left and right in the natural (B, L, L, nc)
or the channel-major (B, nc, L, L) layout (`c_major`); post with the
emitted final gate, reading its input in either layout (`y_c_major`); and
the gate-fold post that recomputes the final gate from the residual.  The
contraction between them is `ops/triangle.py`.  On the card all run
`csrc/row_linear.cu`: pre as its gated-pairs mode (entry
`abx_tri_mult_pre`), post as the plain row linear with a sigmoid gate and
the residual in its epilogue (entry `abx_tri_mult_post_c_major` for the
channel-major input, whose bf16 launches take the Hopper kernel of
`csrc/post_cmajor_sm90.cu` instead: W resident in shared memory, the
channel-major tile normalised in place and fed to wgmma as a transposed
operand), the gate-fold post as two LN-staged products per output tile
(entry `abx_tri_mult_post_gatefold`), whose bf16 launches take the Hopper
kernel of `csrc/gatefold_sm90.cu` instead (both weights resident in shared
memory, the two products on wgmma).  The LayerNorm is
applied while a tile is staged, so the normalised tensor never reaches
device memory; see the source notes there for what bounds them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from abx_tpu_torch.models.modules import layer_norm
from abx_tpu_torch.ops import _lib, registry

_HALF = 64   # value channels per packed N tile (csrc/row_linear.cu kHalf)


def _linear_f32(a, w):
    """a @ w^T of values in the input dtype, summed in f32 (the TPU
    kernels' preferred_element_type=f32): no rounding of the product."""
    return F.linear(a.float(), w.float())


def _nc(w, c: int, emit_fgate: bool) -> int:
    return (w.shape[0] - c) // 4 if emit_fgate else w.shape[0] // 4


def tri_mult_pre_plain(x, scale, bias, w, wb, mask, eps: float = 1e-5,
                       emit_fgate: bool = True, c_major: bool = False,
                       packed=None):
    """Plain PyTorch version, at the Pallas kernel's rounding points (and
    with `c_major` the channels of left and right moved in front of the
    positions): LN in f32, rounded to the input dtype; the product of
    values in the input dtype summed in f32 (as preferred_element_type=
    f32); bias, gating and mask in f32, each output rounded once.
    `packed` (the kernel's weights) is not used."""
    nc = _nc(w, x.shape[-1], emit_fgate)
    dt = x.dtype
    ln = layer_norm(x, scale, bias, eps, dtype=dt)
    y = _linear_f32(ln, w.to(dt)) + wb.float()
    pm = (mask[:, :, None] * mask[:, None, :]).float()[..., None]
    left = y[..., :nc] * torch.sigmoid(y[..., 2 * nc:3 * nc]) * pm
    right = y[..., nc:2 * nc] * torch.sigmoid(y[..., 3 * nc:4 * nc]) * pm
    if c_major:
        left, right = (a.permute(0, 3, 1, 2).contiguous()
                       for a in (left, right))
    if not emit_fgate:
        return left.to(dt), right.to(dt)
    return left.to(dt), right.to(dt), y[..., 4 * nc:].to(dt)


def _pack(value, gate):
    """[64 value rows | their 64 gate rows] per 64-channel chunk, the last
    chunk padded with zero rows: the N-tile layout of the gated mode."""
    nc = value.shape[0]
    pad = -nc % _HALF

    def chunks(a):
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        return a.reshape((-1, _HALF) + a.shape[1:])
    return torch.stack([chunks(value), chunks(gate)], dim=1).reshape(
        (-1,) + value.shape[1:])


class PrePack(NamedTuple):
    """tri_mult_pre's weights as the kernel takes them: the packed (N, C)
    weight in the compute dtype, its f32 bias and the f32 LayerNorm
    params; `w` and `wb` are the five (or four) projections stacked in
    order, as the wrapper's arguments."""
    w: torch.Tensor
    wb: torch.Tensor
    w_packed: torch.Tensor
    b_packed: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def pack_pre(weights, biases, scale, bias, dtype) -> PrePack:
    """PrePack of the projections [left, right, left gate, right gate(,
    final gate)] ((nc, C) or (C, C) weights, nn.Linear layout, and their
    biases) and the LayerNorm params, for the compute dtype `dtype`."""
    w, wb = torch.cat(list(weights)), torch.cat(list(biases))
    wf, bf = [t.float() for t in weights], [t.float() for t in biases]
    w_packed = torch.cat([_pack(wf[0], wf[2]), _pack(wf[1], wf[3]),
                          *wf[4:]]).to(dtype).contiguous()
    b_packed = torch.cat([_pack(bf[0], bf[2]), _pack(bf[1], bf[3]),
                          *bf[4:]]).contiguous()
    return PrePack(w, wb, w_packed, b_packed, scale.float().contiguous(),
                   bias.float().contiguous())


def tri_mult_pre(x, scale, bias, w, wb, mask, emit_fgate: bool = True,
                 c_major: bool = False, packed: PrePack | None = None):
    """LN -> fused [left|right|left gate|right gate(|final gate)]
    projection -> left * sigmoid(left gate) * pair mask, likewise right.

    Args:
        x: (B, L, L, C) pair activations.
        scale, bias: (C,) LayerNorm params.
        w: (4*nc + C, C), wb: (4*nc + C,): the five projections stacked
            in that order (nn.Linear layout) -- or (4*nc, C), (4*nc,)
            without the final gate when `emit_fgate=False` (the gate-fold
            post recomputes it).
        mask: (B, L) sequence mask; the pair mask is mask_i * mask_j.
        c_major: left and right as (B, nc, L, L), the operand layout of
            `triangle_multiply_c_major`.
        packed: the same weights as `pack_pre` packs them for x.dtype (a
            module caches it, so a call launches the kernel alone); packed
            here when None.
    Returns: left, right (B, L, L, nc) -- (B, nc, L, L) with `c_major` --
        and, with `emit_fgate`, the pre-sigmoid final gate (B, L, L, C),
        all in x.dtype.
    """
    if not registry.on_device(x):
        return tri_mult_pre_plain(x, scale, bias, w, wb, mask,
                                  emit_fgate=emit_fgate, c_major=c_major)
    _lib.refuse_autograd('tri_mult_pre', x, scale, bias, w, wb)
    b, r, l, c = x.shape
    nc = _nc(w, c, emit_fgate)
    n_fg = c if emit_fgate else 0
    dt = x.dtype
    _lib.require(r == l and w.shape == (4 * nc + n_fg, c)
                 and wb.shape == (4 * nc + n_fg,) and mask.shape == (b, l),
                 'tri_mult_pre: x (B, L, L, C), w (4*nc [+ C], C), wb, '
                 'mask (B, L)')
    if packed is None:
        packed = pack_pre(torch.split(w, [nc] * 4 + [n_fg])[:4 + bool(n_fg)],
                          torch.split(wb, [nc] * 4 + [n_fg])[:4 + bool(n_fg)],
                          scale, bias, dt)
    w_packed, b_packed = packed.w_packed, packed.b_packed
    scale, bias = packed.scale, packed.bias
    _lib.require(w_packed.shape == (4 * _HALF * -(-nc // _HALF) + n_fg, c),
                 'tri_mult_pre: packed weights of another shape')
    maskf = mask if mask.dtype == torch.float32 else mask.float()
    _lib.check_cuda_inputs('tri_mult_pre', dt, x=x, w=w_packed,
                           f32=dict(wb=b_packed, scale=scale, bias=bias,
                                    mask=maskf))
    _lib.require(scale.shape == (c,) and bias.shape == (c,),
                 'tri_mult_pre: LN params must be (C,)')
    lr_shape = (2, b, nc, r, l) if c_major else (2, b, r, l, nc)
    lr = torch.empty(lr_shape, dtype=dt, device=x.device)
    fg = (torch.empty((b, r, l, c), dtype=dt, device=x.device)
          if emit_fgate else None)
    err = _lib.lib().abx_tri_mult_pre(
        _lib.DTYPE_CODE[dt], x.data_ptr(), b * r * l, c, scale.data_ptr(),
        bias.data_ptr(), w_packed.data_ptr(), b_packed.data_ptr(),
        w_packed.shape[0], maskf.data_ptr(), r, l, nc, int(c_major),
        lr.data_ptr(), _lib.ptr(fg), _lib.stream(x))
    _lib.check(err, 'tri_mult_pre')
    tri_mult_pre.launches += 1
    tri_mult_pre.launches_c_major += int(c_major)
    if not emit_fgate:
        tri_mult_pre.launches_no_fgate += 1
        return lr[0], lr[1]
    return lr[0], lr[1], fg


# All launches, and those of the emit_fgate=False and c_major variants
# among them.
tri_mult_pre.launches = 0
tri_mult_pre.launches_no_fgate = 0
tri_mult_pre.launches_c_major = 0


def tri_mult_post_plain(y, scale, bias, w, wb, fg, res, eps: float = 1e-5,
                        y_c_major: bool = False, packed=None):
    """Plain PyTorch version, at the Pallas kernel's rounding points (a
    channel-major y moved to the natural layout first): LN in f32, rounded
    to the input dtype; the product summed in f32; bias, gate and residual
    in f32, rounded once.  `packed` (the kernel's weights) is not used."""
    if y_c_major:
        y = y.permute(0, 2, 3, 1)
    dt = y.dtype
    ln = layer_norm(y, scale, bias, eps, dtype=dt)
    o = _linear_f32(ln, w.to(dt)) + wb.float()
    o = o * torch.sigmoid(fg.float())
    return (o + res.float()).to(res.dtype)


class PostPack(NamedTuple):
    """tri_mult_post's weights as the kernels take them: w (C, nc) in the
    compute dtype, its f32 bias and the f32 LayerNorm params."""
    scale: torch.Tensor
    bias: torch.Tensor
    w: torch.Tensor
    wb: torch.Tensor


def pack_post(scale, bias, w, wb, dtype) -> PostPack:
    return PostPack(scale.float().contiguous(), bias.float().contiguous(),
                    w.to(dtype).contiguous(), wb.float().contiguous())


def post_c_major_hopper_route(y, res) -> bool:
    """True when a channel-major launch (y (B, nc, R, L)) takes the Hopper
    kernel (csrc/post_cmajor_sm90.cu): bf16, nc <= 128 and C <= 192, both
    multiples of 8, R*L a multiple of 8, 16-byte aligned y and res; the
    tile kernel of csrc/row_linear.cu takes the rest (f32 among them).
    Decided before the launch."""
    nc, c = y.shape[1], res.shape[-1]
    return (y.dtype == torch.bfloat16 and nc % 8 == 0 and nc <= 128
            and c % 8 == 0 and c <= 192 and (y.shape[2] * y.shape[3]) % 8 == 0
            and y.data_ptr() % 16 == 0 and res.data_ptr() % 16 == 0)


def tri_mult_post(y, scale, bias, w, wb, fg, res, y_c_major: bool = False,
                  packed: PostPack | None = None):
    """LN -> Linear(nc, C) -> * sigmoid(fg) -> + res.

    Args:
        y: (B, L, L, nc) triangle contraction output -- or (B, nc, L, L)
            with `y_c_major`, the output layout of
            `triangle_multiply_c_major`.
        scale, bias: (nc,) LayerNorm params.
        w: (C, nc), wb: (C,) (nn.Linear layout).
        fg: (B, L, L, C) pre-sigmoid final gate; res: (B, L, L, C).
        packed: the same weights as `pack_post` packs them for y.dtype (a
            module caches it, so a call launches the kernel alone); packed
            here when None.
    Returns: (B, L, L, C) in y.dtype.
    """
    if not registry.on_device(y):
        return tri_mult_post_plain(y, scale, bias, w, wb, fg, res,
                                   y_c_major=y_c_major)
    _lib.refuse_autograd('tri_mult_post', y, scale, bias, w, wb, fg, res)
    if y_c_major:
        b, nc, r, l = y.shape
    else:
        b, r, l, nc = y.shape
    c = w.shape[0]
    dt = y.dtype
    y = y.contiguous()
    pk = packed if packed is not None else pack_post(scale, bias, w, wb, dt)
    _lib.check_cuda_inputs('tri_mult_post', dt, y=y, w=pk.w, fg=fg, res=res,
                           f32=dict(wb=pk.wb, scale=pk.scale, bias=pk.bias))
    _lib.require(pk.w.shape == (c, nc) and pk.wb.shape == (c,)
                 and pk.scale.shape == (nc,) and pk.bias.shape == (nc,)
                 and fg.shape == (b, r, l, c) and res.shape == (b, r, l, c),
                 'tri_mult_post: w (C, nc), wb (C,), LN params (nc,), '
                 'fg and res (B, L, L, C)')
    out = torch.empty_like(res)
    if y_c_major and post_c_major_hopper_route(y, res):
        err = _lib.lib().abx_tri_mult_post_c_major_sm90(
            y.data_ptr(), b, nc, r * l, c, pk.scale.data_ptr(),
            pk.bias.data_ptr(), pk.w.data_ptr(), pk.wb.data_ptr(),
            fg.data_ptr(), res.data_ptr(), out.data_ptr(), _lib.stream(y))
    elif y_c_major:
        err = _lib.lib().abx_tri_mult_post_c_major(
            _lib.DTYPE_CODE[dt], y.data_ptr(), b * r * l, nc,
            pk.scale.data_ptr(), pk.bias.data_ptr(), pk.w.data_ptr(),
            pk.wb.data_ptr(), fg.data_ptr(), res.data_ptr(), out.data_ptr(),
            c, r, l, _lib.stream(y))
    else:
        err = _lib.lib().abx_row_linear(
            _lib.DTYPE_CODE[dt], y.data_ptr(), b * r * l, nc, nc,
            pk.scale.data_ptr(), pk.bias.data_ptr(), pk.w.data_ptr(),
            pk.wb.data_ptr(), res.data_ptr(), fg.data_ptr(), out.data_ptr(),
            c, 0, 1, 1, _lib.stream(y))
    _lib.check(err, 'tri_mult_post')
    tri_mult_post.launches += 1
    tri_mult_post.launches_c_major += int(y_c_major)
    return out


# All launches, and those of the y_c_major variant among them.
tri_mult_post.launches = 0
tri_mult_post.launches_c_major = 0


def tri_mult_post_gatefold_plain(y, scale, bias, w, wb, x_scale, x_bias, wg,
                                 wgb, res, eps: float = 1e-5, packed=None):
    """Plain PyTorch version, at the Pallas kernel's rounding points: LN(y)
    and LN_x(res) in f32, each rounded to the input dtype; both products
    summed in f32; the final gate recomputed from res with the pre block's
    LayerNorm and kept in f32; bias, gate and residual in f32, rounded
    once.  `packed` (the kernel's weights) is not used."""
    dt = y.dtype
    ln = layer_norm(y, scale, bias, eps, dtype=dt)
    o = _linear_f32(ln, w.to(dt)) + wb.float()
    lnx = layer_norm(res, x_scale, x_bias, eps, dtype=res.dtype)
    fg = _linear_f32(lnx, wg.to(res.dtype)) + wgb.float()
    o = o * torch.sigmoid(fg)
    return (o + res.float()).to(res.dtype)


class GatefoldPack(NamedTuple):
    """tri_mult_post_gatefold's weights as the kernels take them: w (C,
    nc) and wg (C, C) in the compute dtype, the biases and both LayerNorms'
    params in f32."""
    scale: torch.Tensor
    bias: torch.Tensor
    w: torch.Tensor
    wb: torch.Tensor
    x_scale: torch.Tensor
    x_bias: torch.Tensor
    wg: torch.Tensor
    wgb: torch.Tensor


def pack_gatefold(scale, bias, w, wb, x_scale, x_bias, wg, wgb,
                  dtype) -> GatefoldPack:
    f32 = [p.float().contiguous() for p in (scale, bias, wb, x_scale,
                                            x_bias, wgb)]
    return GatefoldPack(f32[0], f32[1], w.to(dtype).contiguous(), f32[2],
                        f32[3], f32[4], wg.to(dtype).contiguous(), f32[5])


def gatefold_hopper_route(y, res) -> bool:
    """True when a launch takes the Hopper kernel (csrc/gatefold_sm90.cu):
    bf16, nc <= 128 and C <= 192, both multiples of 8, 16-byte aligned y
    and res; the tile kernel of csrc/row_linear.cu takes the rest (f32
    among them).  Decided before the launch."""
    nc, c = y.shape[-1], res.shape[-1]
    return (y.dtype == torch.bfloat16 and nc % 8 == 0 and nc <= 128
            and c % 8 == 0 and c <= 192 and y.data_ptr() % 16 == 0
            and res.data_ptr() % 16 == 0)


def tri_mult_post_gatefold(y, scale, bias, w, wb, x_scale, x_bias, wg, wgb,
                           res, packed: GatefoldPack | None = None):
    """tri_mult_post with the final gate recomputed from `res`:
    (LN(y) @ w^T + wb) * sigmoid(LN_x(res) @ wg^T + wgb) + res.

    Args:
        y: (B, L, L, nc) triangle contraction output.
        scale, bias: (nc,) final LayerNorm params.
        w: (C, nc), wb: (C,) (nn.Linear layout).
        x_scale, x_bias: (C,) the pre block's LayerNorm params.
        wg: (C, C), wgb: (C,): the final-gate projection.
        res: (B, L, L, C), the pre block's input.
        packed: the same weights as `pack_gatefold` packs them for y.dtype
            (a module caches it, so a call launches the kernel alone);
            packed here when None.
    Returns: (B, L, L, C) in res.dtype.
    """
    if not registry.on_device(y):
        return tri_mult_post_gatefold_plain(y, scale, bias, w, wb, x_scale,
                                            x_bias, wg, wgb, res)
    _lib.refuse_autograd('tri_mult_post_gatefold', y, scale, bias, w, wb,
                         x_scale, x_bias, wg, wgb, res)
    b, r, l, nc = y.shape
    c = w.shape[0]
    dt = y.dtype
    y, res = y.contiguous(), res.contiguous()
    if packed is None:
        packed = pack_gatefold(scale, bias, w, wb, x_scale, x_bias, wg, wgb,
                               dt)
    pk = packed
    _lib.check_cuda_inputs('tri_mult_post_gatefold', dt, y=y, w=pk.w,
                           wg=pk.wg, res=res,
                           f32=dict(wb=pk.wb, scale=pk.scale, bias=pk.bias,
                                    x_scale=pk.x_scale, x_bias=pk.x_bias,
                                    wgb=pk.wgb))
    _lib.require(pk.w.shape == (c, nc) and pk.wg.shape == (c, c)
                 and pk.wb.shape == (c,) and pk.wgb.shape == (c,)
                 and pk.scale.shape == (nc,) and pk.bias.shape == (nc,)
                 and pk.x_scale.shape == (c,) and pk.x_bias.shape == (c,)
                 and res.shape == (b, r, l, c),
                 'tri_mult_post_gatefold: w (C, nc), wg (C, C), wb and wgb '
                 '(C,), LN params (nc,) and (C,), res (B, L, L, C)')
    out = torch.empty_like(res)
    args = (y.data_ptr(), res.data_ptr(), b * r * l, nc, c,
            pk.scale.data_ptr(), pk.bias.data_ptr(), pk.w.data_ptr(),
            pk.wb.data_ptr(), pk.x_scale.data_ptr(), pk.x_bias.data_ptr(),
            pk.wg.data_ptr(), pk.wgb.data_ptr(), out.data_ptr(),
            _lib.stream(y))
    if gatefold_hopper_route(y, res):
        err = _lib.lib().abx_tri_mult_post_gatefold_sm90(*args)
    else:
        err = _lib.lib().abx_tri_mult_post_gatefold(_lib.DTYPE_CODE[dt],
                                                     *args)
    _lib.check(err, 'tri_mult_post_gatefold')
    tri_mult_post_gatefold.launches += 1
    return out


tri_mult_post_gatefold.launches = 0
