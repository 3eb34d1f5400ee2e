"""The port's CUDA kernels against their plain PyTorch versions.

Torch-only (no jax), so that it runs on the machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

The `gpu`-marked tests skip without a CUDA device.  On the card, f32
inputs are held to the plain f32 version at 1e-4 * max|ref| and bf16
inputs at 3e-2 * max|ref| of the f32 plain version.  The shared case
builders here are also used by tests/test_torch_ops.py against the JAX
package.
"""

import ctypes
import functools
import multiprocessing
import re

import numpy as np
import pytest
import torch

from abx_tpu_torch.ops import _lib
from abx_tpu_torch.ops import esm_attention as esm_op
from abx_tpu_torch.ops import esm_layer_norm as esm_ln_op
from abx_tpu_torch.ops import gate_proj as gate_proj_op
from abx_tpu_torch.ops import ipa_attend as ipa_attend_op
from abx_tpu_torch.ops import ipa_attention as ipa_op
from abx_tpu_torch.ops import pair_bias as pair_bias_op
from abx_tpu_torch.ops import recycle_embed as recycle_op
from abx_tpu_torch.ops import transition as transition_op
from abx_tpu_torch.ops import tri_attention as tri_op
from abx_tpu_torch.ops import tri_mult as tri_mult_op
from abx_tpu_torch.ops import triangle as triangle_op


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _ln_np(x, scale, bias):
    m = x.mean(-1, keepdims=True)
    v = np.maximum((x * x).mean(-1, keepdims=True) - m * m, 0.0)
    return (x - m) / np.sqrt(v + 1e-5) * scale + bias


def _mask(rng, b, l):
    mask = np.ones((b, l), np.float32)
    mask[:, -2:] = 0.0
    mask[0, rng.integers(0, l - 2)] = 0.0
    return mask


def _tri_case(seed, b, r, l, h, d, c_out, orientation):
    rng = np.random.default_rng(seed)
    c = h * d
    x = rng.standard_normal((b, r, l, c)).astype(np.float32)
    if orientation == 'per_column':
        x = np.ascontiguousarray(np.swapaxes(x, 1, 2))
    return dict(
        x=x,
        scale=(rng.random(c) + 0.5).astype(np.float32),
        lnb=(0.1 * rng.standard_normal(c)).astype(np.float32),
        w=[(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
           for _ in range(4)],
        bg=(0.1 * rng.standard_normal(c)).astype(np.float32),
        wo=(rng.standard_normal((c, c_out)) / np.sqrt(c)).astype(np.float32),
        bo=(0.1 * rng.standard_normal(c_out)).astype(np.float32),
        res=rng.standard_normal(x.shape[:3] + (c_out,)).astype(np.float32),
        bias=rng.standard_normal((b, h, x.shape[2], x.shape[2])).astype(
            np.float32),
        mask=_mask(rng, b, x.shape[2]))


def _tri_port(k, full=True, fn=None):
    fn = fn or tri_op.triangle_attention_packed_plain
    wq, wk, wv, wg = (t(w.T) for w in k['w'])
    kw = {}
    if full:
        kw = dict(ln=(t(k['scale']), t(k['lnb'])), gate=(wg, t(k['bg'])),
                  out_proj=(t(k['wo'].T), t(k['bo'])), residual=t(k['res']))
    return fn(t(k['x']), wq, wk, wv, t(k['bias']), t(k['mask']), **kw)


def _pair_bias_case(seed, b, r, l, c, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, r, l, c)).astype(np.float32),
            (rng.random(c) + 0.5).astype(np.float32),
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal((c, h)).astype(np.float32))


def _transition_case(seed, b, r, l, c, factor=4):
    rng = np.random.default_rng(seed)
    n = c * factor
    return (rng.standard_normal((b, r, l, c)).astype(np.float32),
            (rng.random(c) + 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((c, n)) / np.sqrt(c)).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32),
            (rng.standard_normal((n, c)) / np.sqrt(n)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _ipa_case(seed, b, l, h, ds, pq, pv, c):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [(0.5 * rng.standard_normal((b, l, h, ds))).astype(f),
            (0.5 * rng.standard_normal((b, l, h, ds))).astype(f),
            rng.standard_normal((b, l, h, ds)).astype(f),
            rng.standard_normal((b, l, h, pq, 3)).astype(f),
            rng.standard_normal((b, l, h, pq, 3)).astype(f),
            rng.standard_normal((b, l, h, pv, 3)).astype(f),
            (-0.3 * (rng.random(h) + 0.5)).astype(f),
            rng.standard_normal((b, h, l, l)).astype(f),
            _mask(rng, b, l),
            rng.standard_normal((b, l, l, c)).astype(f)]


def _tri_mult_pre_case(seed, b, l, c, nc):
    """x, scale, bias, w (C, 4*nc + C) flax layout, wb, mask."""
    rng = np.random.default_rng(seed)
    n = 4 * nc + c
    return (rng.standard_normal((b, l, l, c)).astype(np.float32),
            (rng.random(c) + 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            (rng.standard_normal((c, n)) / np.sqrt(c)).astype(np.float32),
            (0.5 * rng.standard_normal(n)).astype(np.float32),
            _mask(rng, b, l))


def _tri_mult_post_case(seed, b, l, nc, c):
    """y, scale, bias, w (nc, C) flax layout, wb, fg, res."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, l, nc)).astype(np.float32),
            (rng.random(nc) + 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(nc)).astype(np.float32),
            (rng.standard_normal((nc, c)) / np.sqrt(nc)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            rng.standard_normal((b, l, l, c)).astype(np.float32),
            rng.standard_normal((b, l, l, c)).astype(np.float32))


def _no_fgate(args):
    """A tri_mult_pre case without the final-gate columns."""
    x, s, lb, w, wb, mask = args
    nc = (w.shape[1] - x.shape[-1]) // 4
    return x, s, lb, w[:, :4 * nc].copy(), wb[:4 * nc].copy(), mask


def _gatefold_case(seed, b, l, nc, c):
    """y, scale, bias, w (nc, C), wb, x_scale, x_bias, wg (C, C) flax
    layout, wgb, res."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, l, l, nc)).astype(f),
            (rng.random(nc) + 0.5).astype(f),
            (0.1 * rng.standard_normal(nc)).astype(f),
            (rng.standard_normal((nc, c)) / np.sqrt(nc)).astype(f),
            (0.1 * rng.standard_normal(c)).astype(f),
            (rng.random(c) + 0.5).astype(f),
            (0.1 * rng.standard_normal(c)).astype(f),
            (rng.standard_normal((c, c)) / np.sqrt(c)).astype(f),
            (0.5 * rng.standard_normal(c)).astype(f),
            rng.standard_normal((b, l, l, c)).astype(f))


def _gate_proj_case(seed, b, r, l, hd, c):
    """y, gate_pre, w (HD, C) flax layout, wb, res."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, r, l, hd)).astype(f),
            (2.0 * rng.standard_normal((b, r, l, hd))).astype(f),
            (rng.standard_normal((hd, c)) / np.sqrt(hd)).astype(f),
            (0.1 * rng.standard_normal(c)).astype(f),
            rng.standard_normal((b, r, l, c)).astype(f))


def _ipa_attend_case(seed, b, h, l, c):
    """attn (B, H, L, L) softmax rows, pair (B, L, L, C)."""
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((b, h, l, l))
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn /= attn.sum(-1, keepdims=True)
    return (attn.astype(np.float32),
            rng.standard_normal((b, l, l, c)).astype(np.float32))


def _triangle_case(seed, b, l, c):
    """left, right (B, L, L, C)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, l, c)).astype(np.float32)
                 for _ in range(2))


def _gatefold_port(args, fn=None, dtype=torch.float32):
    """The gate-fold case through fn (the plain version by default), y and
    res in `dtype`."""
    fn = fn or tri_mult_op.tri_mult_post_gatefold_plain
    return fn(*_gatefold_args(args, dtype))


def _gatefold_args(args, dtype, dev='cpu'):
    """The gate-fold case as the port's arguments, y and res in `dtype`."""
    y, s, lb, w, wb, xs, xb, wg, wgb, res = (t(a).to(dev) for a in args)
    return (y.to(dtype), s, lb, w.T.contiguous(), wb, xs, xb,
            wg.T.contiguous(), wgb, res.to(dtype))


def _gate_proj_port(args, fn=None, dtype=torch.float32):
    """The gate_proj case through fn, y, gate and res in `dtype`."""
    y, g, w, wb, res = args
    fn = fn or gate_proj_op.gate_proj_residual_plain
    return fn(t(y).to(dtype), t(g).to(dtype), t(w.T), t(wb),
              t(res).to(dtype))


def _recycle_case(seed, b, l, c0, c, n_bins):
    """static_pair, t_vec, prev_pair, scale, bias, table, bins (int)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, l, c0)).astype(np.float32),
            rng.standard_normal((b, c - c0)).astype(np.float32),
            (2.0 * rng.standard_normal((b, l, l, c)) + 0.5).astype(
                np.float32),
            (rng.random(c) + 0.5).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            rng.standard_normal((n_bins, c)).astype(np.float32),
            rng.integers(0, n_bins, (b, l, l)))


def _esm_case(seed, b, h, l, d, strided, all_pad_row=None,
              head_pad_row=None):
    """q (pre-scaled), k, v as (B, H, L, D): head-major views of (B, L, H,
    D) tensors when `strided`, as the ESM module hands them in; a padding
    mask (True = PAD) with padded tails of different lengths, every key
    of batch row `all_pad_row` padded where one is given, and the first
    128 keys of batch row `head_pad_row` (the flash route's first key
    block) where one is given."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, l, h, d)).astype(np.float32)
           for _ in range(3)]
    qkv[0] *= d ** -0.5
    qkv = [t(a).transpose(1, 2) if strided
           else t(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
           for a in qkv]
    pad = np.zeros((b, l), bool)
    for i in range(b):
        pad[i, l - 3 - 5 * i:] = True
    pad[0, rng.integers(0, l // 2)] = True
    if all_pad_row is not None:
        pad[all_pad_row] = True
    if head_pad_row is not None:
        pad[head_pad_row, :128] = True
    return qkv, torch.as_tensor(pad)


def _fused_case(seed, b, r, h, l, d):
    """q, k, v (B, R, H, L, D) head-major, an f32 bias (B, H, L, L) and a
    key mask (B, L)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (*(rng.standard_normal((b, r, h, l, d)).astype(f)
              for _ in range(3)),
            rng.standard_normal((b, h, l, l)).astype(f), _mask(rng, b, l))


def _cols_case(seed, b, l, c, h):
    """x (B, L, L, C) raw, ln scale and bias, wq, wk, wv, wg (C, H*D) flax
    layout with H*D = C, bg, bias (B, H, L, L), mask with the last 3 keys
    masked."""
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones((b, l), f)
    mask[:, -3:] = 0.0
    return (rng.standard_normal((b, l, l, c)).astype(f),
            (rng.random(c) + 0.5).astype(f),
            (0.1 * rng.standard_normal(c)).astype(f),
            *((0.3 * rng.standard_normal((c, c))).astype(f)
              for _ in range(4)),
            (0.1 * rng.standard_normal(c)).astype(f),
            rng.standard_normal((b, h, l, l)).astype(f), mask)


def _cols_port(case, fn=None, **kw):
    fn = fn or tri_op.triangle_attention_packed_cols_plain
    x, s, lb, wq, wk, wv, wg, bg, bias, mask = (t(a) for a in case)
    return fn(x, s, lb, wq.T, wk.T, wv.T, wg.T, bg, bias, mask, **kw)


def _tri_mult_pre_port(args, fn=None):
    x, s, lb, w, wb, mask = args
    fn = fn or tri_mult_op.tri_mult_pre_plain
    return fn(t(x), t(s), t(lb), t(w.T), t(wb), t(mask))


def _tri_mult_post_port(args, fn=None):
    y, s, lb, w, wb, fg, res = args
    fn = fn or tri_mult_op.tri_mult_post_plain
    return fn(t(y), t(s), t(lb), t(w.T), t(wb), t(fg), t(res))


def _recycle_port(args, fn=None):
    fn = fn or recycle_op.recycle_embed_plain
    return fn(*[t(a) for a in args[:-1]], torch.as_tensor(args[-1]))


TRI_SHAPES = [  # (b, r, l, h, d): tri-attention-like and seq-like (D=17)
    (2, 7, 9, 2, 8),
    (2, 1, 13, 4, 17),
    (1, 5, 11, 3, 17),
]


# --- the C interface: ctypes signatures vs the sources ----------------------

def _extern_c_declarations():
    """{name: [parameter declarations]} of every `extern "C"` function in
    abx_tpu_torch/csrc/*.cu."""
    decls = {}
    for src in sorted(_lib.CSRC.glob('*.cu')):
        text = re.sub(r'//[^\n]*', '', src.read_text())
        for name, params in re.findall(
                r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text):
            assert name not in decls, f'{name} declared twice'
            decls[name] = [p.strip() for p in params.split(',') if p.strip()]
    return decls


def test_lib_signatures_match_extern_c_declarations():
    """Every `extern "C"` entry point has a `_SIGNATURES` entry with one
    ctypes type per parameter: c_void_p for a pointer (a c_int there would
    cut the pointer to 32 bits), c_int for an int, c_float for a float (a
    c_int there would pass the number's integer part as the float's
    bits)."""
    decls = _extern_c_declarations()
    assert set(decls) == set(_lib._SIGNATURES)
    for name, params in decls.items():
        want = []
        for p in params:
            if '*' in p:
                want.append(ctypes.c_void_p)
            elif re.fullmatch(r'float\s+\w+', p):
                want.append(ctypes.c_float)
            else:
                assert re.fullmatch(r'int\s+\w+', p), (name, p)
                want.append(ctypes.c_int)
        assert _lib._SIGNATURES[name] == want, name


@pytest.mark.parametrize('tool', ['ablate_transition', 'ablate_kernels'])
def test_ablation_edits_find_their_text(tool):
    """Each variant of the ablation tools edits text that its kernel source
    holds exactly once (the tools raise on the card otherwise)."""
    import importlib
    mod = importlib.import_module(f'abx_tpu_torch.tools.{tool}')
    if tool == 'ablate_transition':
        plans = [(mod.SRC, mod.VARIANTS)]
    else:
        plans = [(_lib.CSRC / src, variants)
                 for src, _, variants in mod.KERNELS.values()]
    for src, variants in plans:
        text = src.read_text()
        for name, edits in variants.items():
            for old, _ in edits:
                assert text.count(old) == 1, (src.name, name, old)


# --- wrappers: CPU tensors take the plain version; counters -----------------

def test_wrappers_on_cpu_run_plain_version_without_counting():
    wrappers = (tri_op.triangle_attention_packed,
                pair_bias_op.pair_bias_proj, transition_op.fused_transition,
                ipa_op.ipa_attention, tri_mult_op.tri_mult_pre,
                tri_mult_op.tri_mult_post, recycle_op.recycle_embed,
                esm_op.esm_attention)
    before = [w.launches for w in wrappers]
    k = _tri_case(5, 1, 3, 7, 2, 8, 16, 'per_row')
    torch.testing.assert_close(
        _tri_port(k, fn=tri_op.triangle_attention_packed), _tri_port(k))
    pair, s, lb, w = _pair_bias_case(5, 1, 5, 5, 8, 2)
    torch.testing.assert_close(
        pair_bias_op.pair_bias_proj(t(pair), t(s), t(lb), t(w.T)),
        pair_bias_op.pair_bias_proj_plain(t(pair), t(s), t(lb), t(w.T)))
    targs = [t(a) for a in _transition_case(5, 1, 3, 5, 8)]
    targs[3], targs[5] = targs[3].T, targs[5].T
    torch.testing.assert_close(transition_op.fused_transition(*targs),
                               transition_op.fused_transition_plain(*targs))
    iargs = [t(a) for a in _ipa_case(5, 1, 6, 2, 4, 2, 2, 16)]
    for g, w in zip(ipa_op.ipa_attention(*iargs),
                    ipa_op.ipa_attention_plain(*iargs)):
        torch.testing.assert_close(g, w)
    pre = _tri_mult_pre_case(5, 1, 7, 8, 4)
    for g, w in zip(_tri_mult_pre_port(pre, tri_mult_op.tri_mult_pre),
                    _tri_mult_pre_port(pre)):
        torch.testing.assert_close(g, w)
    post = _tri_mult_post_case(5, 1, 7, 4, 8)
    torch.testing.assert_close(
        _tri_mult_post_port(post, tri_mult_op.tri_mult_post),
        _tri_mult_post_port(post))
    rec = _recycle_case(5, 1, 6, 8, 12, 5)
    torch.testing.assert_close(_recycle_port(rec, recycle_op.recycle_embed),
                               _recycle_port(rec))
    qkv, pad = _esm_case(5, 2, 3, 9, 8, True)
    torch.testing.assert_close(esm_op.esm_attention(*qkv, pad),
                               esm_op.esm_attention_plain(*qkv, pad))
    assert [w.launches for w in wrappers] == before


def test_opt_in_wrappers_on_cpu_run_plain_version_without_counting():
    wrappers = (gate_proj_op.gate_proj_residual,
                tri_mult_op.tri_mult_post_gatefold,
                ipa_attend_op.ipa_pair_attend,
                triangle_op.triangle_multiply_kernel)
    before = [w.launches for w in wrappers]
    before_pre = (tri_mult_op.tri_mult_pre.launches,
                  tri_mult_op.tri_mult_pre.launches_no_fgate)
    gp = _gate_proj_case(5, 1, 3, 7, 8, 12)
    torch.testing.assert_close(
        _gate_proj_port(gp, gate_proj_op.gate_proj_residual),
        _gate_proj_port(gp))
    gf = _gatefold_case(5, 1, 7, 4, 8)
    torch.testing.assert_close(
        _gatefold_port(gf, tri_mult_op.tri_mult_post_gatefold),
        _gatefold_port(gf))
    pre = _no_fgate(_tri_mult_pre_case(5, 1, 7, 8, 4))
    x, s, lb, w, wb, mask = (t(a) for a in pre)
    got = tri_mult_op.tri_mult_pre(x, s, lb, w.T, wb, mask, emit_fgate=False)
    want = tri_mult_op.tri_mult_pre_plain(x, s, lb, w.T, wb, mask,
                                          emit_fgate=False)
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_)
    attn, pair = (t(a) for a in _ipa_attend_case(5, 1, 3, 6, 8))
    torch.testing.assert_close(ipa_attend_op.ipa_pair_attend(attn, pair),
                               ipa_attend_op.ipa_pair_attend_plain(attn,
                                                                   pair))
    left, right = (t(a) for a in _triangle_case(5, 1, 6, 4))
    for per_row in (True, False):
        want = triangle_op.triangle_multiply_einsum(left, right, per_row)
        for use_pallas in (True, False):
            torch.testing.assert_close(
                triangle_op.triangle_multiply(left, right, per_row,
                                              use_pallas=use_pallas), want)
        torch.testing.assert_close(
            triangle_op.triangle_multiply_kernel(left, right, per_row), want)
    assert [w.launches for w in wrappers] == before
    assert (tri_mult_op.tri_mult_pre.launches,
            tri_mult_op.tri_mult_pre.launches_no_fgate) == before_pre


def test_c_major_and_attention_wrappers_on_cpu_run_plain_version():
    """The channel-major pre / post, the head-major and the column triangle
    attentions: a CPU tensor takes the plain version, counted nowhere."""
    counters = ((tri_mult_op.tri_mult_pre, 'launches'),
                (tri_mult_op.tri_mult_pre, 'launches_c_major'),
                (tri_mult_op.tri_mult_post, 'launches'),
                (tri_mult_op.tri_mult_post, 'launches_c_major'),
                (tri_op.triangle_attention_fused, 'launches'),
                (tri_op.triangle_attention_packed_cols, 'launches'))
    before = [getattr(f, a) for f, a in counters]
    x, s, lb, w, wb, mask = (t(a) for a in _tri_mult_pre_case(5, 1, 7, 8, 4))
    got = tri_mult_op.tri_mult_pre(x, s, lb, w.T, wb, mask, c_major=True)
    want = tri_mult_op.tri_mult_pre_plain(x, s, lb, w.T, wb, mask)
    for g, w_ in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w_.permute(0, 3, 1, 2))
    torch.testing.assert_close(got[2], want[2])
    y, s, lb, w, wb, fg, res = (t(a) for a in
                                _tri_mult_post_case(5, 1, 7, 4, 8))
    torch.testing.assert_close(
        tri_mult_op.tri_mult_post(y.permute(0, 3, 1, 2), s, lb, w.T, wb, fg,
                                  res, y_c_major=True),
        tri_mult_op.tri_mult_post_plain(y, s, lb, w.T, wb, fg, res))
    fused = [t(a) for a in _fused_case(5, 1, 3, 2, 9, 8)]
    torch.testing.assert_close(tri_op.triangle_attention_fused(*fused),
                               tri_op.triangle_attention_fused_plain(*fused))
    cols = _cols_case(5, 1, 9, 8, 2)
    torch.testing.assert_close(
        _cols_port(cols, tri_op.triangle_attention_packed_cols),
        _cols_port(cols))
    assert [getattr(f, a) for f, a in counters] == before


# --- on the card: CUDA kernel vs plain version ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run only on the card)')
    return _card()


def _card():
    """The card, with TF32 off (the f32 bars assume full f32 products)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close_on_card(got, want, dtype):
    """max|got - want| <= tol * max|want|: tol = 1e-4 for f32 (the bf16x3
    products carry ~16 mantissa bits, so an output's error scales with the
    magnitude of the terms summed into it, not with the output itself) and
    3e-2 for bf16 against the f32 plain version."""
    got, want = got.float().cpu(), want.float().cpu()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_SHAPES + [(1, 3, 70, 4, 48),
                                   (1, 3, 288, 4, 48), (1, 2, 100, 4, 17)])
def test_tri_attention_kernel_matches_plain(cuda, shape, dtype):
    b, r, l, h, d = shape
    k = _tri_case(6, b, r, l, h, d, h * d, 'per_row')
    wq, wk, wv, wg = (t(w.T).to(cuda) for w in k['w'])
    kw = dict(ln=(t(k['scale']).to(cuda), t(k['lnb']).to(cuda)),
              gate=(wg, t(k['bg']).to(cuda)),
              out_proj=(t(k['wo'].T).to(cuda), t(k['bo']).to(cuda)))
    x, bias, mask = (t(k[n]).to(cuda) for n in ('x', 'bias', 'mask'))
    res = t(k['res']).to(cuda)
    want = tri_op.triangle_attention_packed_plain(
        x, wq, wk, wv, bias, mask, residual=res, **kw)
    got = tri_op.triangle_attention_packed(
        x.to(dtype), wq, wk, wv, bias, mask, residual=res.to(dtype), **kw)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_pair_bias_kernel_matches_plain(cuda, dtype):
    pair, s, lb, w = (t(a).to(cuda) for a in
                      _pair_bias_case(7, 2, 9, 70, 40, 5))
    want = pair_bias_op.pair_bias_proj_plain(pair, s, lb, w.T)
    got = pair_bias_op.pair_bias_proj(pair.to(dtype), s, lb, w.T)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_transition_kernel_matches_plain(cuda, dtype):
    x, s, lb, w1, b1, w2, b2 = (t(a).to(cuda) for a in
                                _transition_case(8, 2, 5, 70, 48))
    want = transition_op.fused_transition_plain(x, s, lb, w1.T, b1, w2.T, b2)
    got = transition_op.fused_transition(x.to(dtype), s, lb,
                                         w1.T.contiguous(), b1,
                                         w2.T.contiguous(), b2)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ipa_attention_kernel_matches_plain(cuda, dtype):
    args = [t(a).to(cuda) for a in _ipa_case(9, 2, 37, 3, 16, 4, 8, 32)]
    want = ipa_op.ipa_attention_plain(*args)
    low = [a.to(dtype) if i in (0, 1, 2, 9) else a
           for i, a in enumerate(args)]
    got = ipa_op.ipa_attention(*low)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close_on_card(g, w, dtype)


# (b, l, c, nc): nc below one 64-channel chunk, and above one with a ragged
# last chunk; odd L.
TRI_MULT_SHAPES = [(2, 37, 48, 40), (1, 21, 40, 72)]


def _on_card(args, dev, dtype, low):
    """numpy case -> f32 card tensors, and the ones at `low` in dtype."""
    f32 = [t(a).to(dev) if a.dtype.kind == 'f'
           else torch.as_tensor(a).to(dev) for a in args]
    return f32, [a.to(dtype) if i in low else a for i, a in enumerate(f32)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_pre_kernel_matches_plain(cuda, shape, dtype):
    x, s, lb, w, wb, mask = _tri_mult_pre_case(10, *shape)
    f32, low = _on_card((x, s, lb, w.T.copy(), wb, mask), cuda, dtype, {0})
    want = tri_mult_op.tri_mult_pre_plain(*f32)
    got = tri_mult_op.tri_mult_pre(*low)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        _close_on_card(g, w_, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_post_kernel_matches_plain(cuda, shape, dtype):
    b, l, c, nc = shape
    y, s, lb, w, wb, fg, res = _tri_mult_post_case(11, b, l, nc, c)
    f32, low = _on_card((y, s, lb, w.T.copy(), wb, fg, res), cuda, dtype,
                        {0, 5, 6})
    want = tri_mult_op.tri_mult_post_plain(*f32)
    got = tri_mult_op.tri_mult_post(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 37, 128, 192, 15),
                                   (1, 9, 20, 36, 7)])
def test_recycle_embed_kernel_matches_plain(cuda, shape, dtype):
    f32, low = _on_card(_recycle_case(12, *shape), cuda, dtype, {0, 2})
    want = recycle_op.recycle_embed_plain(*f32)
    got = recycle_op.recycle_embed(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


# (b, l, c0, c, n_bins, t repeats, t_dtype): M not a multiple of the 32-row
# group, C0 and C not multiples of 8 (pieces straddling C0, element
# stores), C = 256 (four pieces a lane), the time vector repeated, in bf16.
RECYCLE_SHAPES = [(2, 37, 128, 192, 15, 2, torch.bfloat16),
                  (1, 9, 20, 36, 7, 1, torch.float32),
                  (3, 11, 16, 32, 15, 2, torch.float32),
                  (1, 13, 60, 256, 5, 4, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', RECYCLE_SHAPES)
def test_recycle_embed_ragged_matches_plain(cuda, shape, dtype):
    """The kernel against its plain version, three bins out of range (they
    add zero)."""
    b, l, c0, c, n_bins, tiles, t_dtype = shape
    case = list(_recycle_case(34, b, l, c0, c, n_bins))
    # The time vector's values exact in t_dtype, so the f32 plain version
    # sees the ones the call does.
    case[1] = t(case[1][:, :(c - c0) // tiles]).to(t_dtype).float().numpy()
    case[-1][0, 0, :3] = [-1, n_bins, n_bins + 2]
    f32, low = _on_card(case, cuda, dtype, {0, 2})
    low[1] = low[1].to(t_dtype)
    want = recycle_op.recycle_embed_plain(*f32)
    got = recycle_op.recycle_embed(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 3, 70, 64, True, None),
                                   (1, 4, 133, 32, False, None),
                                   (2, 2, 17, 24, True, None),
                                   (4, 40, 306, 64, True, None),
                                   (2, 3, 70, 16, True, None),
                                   (2, 2, 97, 128, True, None),
                                   (3, 2, 70, 64, True, 1)])
def test_esm_attention_kernel_matches_plain(cuda, shape, dtype):
    """Ragged L (not a multiple of 16 or 64), D = 16, 24 (padded to 32),
    32, 64 and 128, strided and contiguous operands, padded keys, the full
    ESM2-3B head shape, and a batch row whose every key is padded (its
    softmax is uniform over the L keys, as in the plain version)."""
    *dims, strided, all_pad_row = shape
    qkv, pad = _esm_case(13, *dims, strided, all_pad_row)
    qkv, pad = [a.to(cuda) for a in qkv], pad.to(cuda)
    want = esm_op.esm_attention_plain(*qkv, pad)
    got = esm_op.esm_attention(*[a.to(dtype) for a in qkv], pad)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b, l', [(32, 122), (8, 109)])
def test_esm_attention_kernel_takes_the_pll_shapes(cuda, b, l, dtype):
    """The masked-PLL batches (`evaluation/pll.py`) at ESM2-3B's heads: 32
    masked copies of a 120-residue chain (L = n + 2) and a last batch of 8
    of a 107-residue one, no key padded, in f32 (the PLL CLI's dtype) and
    bf16."""
    qkv, _ = _esm_case(15, b, 40, l, 64, True)
    qkv = [a.to(cuda) for a in qkv]
    pad = torch.zeros(b, l, dtype=torch.bool, device=cuda)
    want = esm_op.esm_attention_plain(*qkv, pad)
    got = esm_op.esm_attention(*[a.to(dtype) for a in qkv], pad)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
def test_esm_attention_launches_one_device_kernel(cuda):
    """With a bool padding mask the wrapper launches its kernel and nothing
    else: the key-pad bias is read by the kernel, not built per call."""
    from torch.profiler import ProfilerActivity, profile
    qkv, pad = _esm_case(14, 2, 3, 70, 64, True)
    qkv = [a.to(cuda).bfloat16() for a in qkv]
    pad = pad.to(cuda)
    esm_op.esm_attention(*qkv, pad)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        esm_op.esm_attention(*qkv, pad)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and 'flash_kernel' in names[0], names


def test_esm_flash_wrapper_on_cpu_runs_plain_version_without_counting():
    """The flash route's wrapper on CPU tensors is its plain version, whose
    valid rows are esm_attention's, and counts nothing."""
    before = (esm_op.esm_flash_attention.launches,
              esm_op.esm_attention.launches)
    qkv, pad = _esm_case(5, 2, 3, 9, 8, True)
    got = esm_op.esm_flash_attention(*qkv, pad)
    torch.testing.assert_close(got, esm_op.esm_flash_attention_plain(*qkv,
                                                                     pad))
    valid = ~pad[:, None, :, None].expand(got.shape)
    torch.testing.assert_close(
        got[valid], esm_op.esm_attention_plain(*qkv, pad)[valid])
    assert (esm_op.esm_flash_attention.launches,
            esm_op.esm_attention.launches) == before


# (b, h, l, d, strided, all_pad_row[, head_pad_row]): one 128-key block
# (L <= 128, the stock kernel's one-step path) and two or three (L = 133,
# 260, 306), ragged L, D = 16, 24 (padded to 32), 32, 64, strided and
# contiguous operands, and a batch row whose every position is padded;
# then L a multiple of 128 (no zero tail: L = 128, 256, 384), L = 129 (a
# tail of 127 keys), and a batch row whose first 128 keys are all padded
# (its valid queries see no key of the first block).
ESM_FLASH_SHAPES = [(2, 3, 70, 64, True, None), (1, 4, 133, 32, False, None),
                    (2, 2, 17, 24, True, None), (4, 40, 306, 64, True, None),
                    (2, 3, 260, 16, True, None), (3, 2, 150, 64, True, 1),
                    (32, 40, 122, 64, True, None),
                    (2, 3, 128, 64, True, None), (1, 4, 256, 32, False, None),
                    (2, 3, 129, 64, True, None), (2, 2, 384, 64, True, None),
                    (3, 2, 300, 64, True, None, 1)]
# bf16 only: D = 128 (the f32 instance stops at 64), one and three blocks.
ESM_FLASH_BF16_SHAPES = [(2, 2, 97, 128, True, None),
                         (2, 3, 300, 128, False, None, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', ESM_FLASH_SHAPES)
def test_esm_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    """Every row, the padded ones included (the kernel computes the stock
    kernel's function on all of them): f32 and bf16 against the f32 plain
    version at the card's bars; bf16 against the bf16 plain version (the
    stock kernel's rounding points: P rounded against the running max of
    each 128-key block, or normalised where L <= 128): at most 1% of the
    outputs differ by more than one bf16 step."""
    _check_esm_flash(cuda, shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('shape', ESM_FLASH_BF16_SHAPES)
def test_esm_flash_attention_bf16_d128_matches_plain(cuda, shape):
    """The bf16 Hopper kernel's D = 128 instance (two 64-column boxes a
    tile) at the bars of the test above."""
    _check_esm_flash(cuda, shape, torch.bfloat16)


def _check_esm_flash(cuda, shape, dtype):
    *dims, strided, all_pad_row = shape[:6]
    qkv, pad = _esm_case(16, *dims, strided, all_pad_row, *shape[6:])
    qkv, pad = [a.to(cuda) for a in qkv], pad.to(cuda)
    low = [a.to(dtype) for a in qkv]
    want = esm_op.esm_flash_attention_plain(*qkv, pad)
    got = esm_op.esm_flash_attention(*low, pad)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    _close_on_card(got, want, dtype)
    if dtype == torch.bfloat16:
        want16 = esm_op.esm_flash_attention_plain(*low, pad).float()
        step = torch.ldexp(torch.ones_like(want16),
                           torch.frexp(want16).exponent - 8)
        share = ((got.float() - want16).abs() > step).float().mean().item()
        assert share <= 1e-2, share


@pytest.mark.gpu
def test_esm_flash_attention_launches_its_kernel_by_dtype(cuda):
    """One call launches one device kernel: in bf16 the Hopper kernel
    (esm_flash_sm90.cu), in f32 the core's segment mode (flash_kernel);
    profiled in a process of its own."""
    _in_own_process(_esm_flash_launches_its_kernel_by_dtype)


def _esm_flash_launches_its_kernel_by_dtype():
    from torch.profiler import ProfilerActivity, profile
    cuda = _card()
    qkv, pad = _esm_case(18, 2, 3, 300, 64, True)
    pad = pad.to(cuda)
    for dtype, want, not_want in ((torch.bfloat16, 'esm_flash_sm90_kernel',
                                   None),
                                  (torch.float32, 'flash_kernel', 'sm90')):
        low = [a.to(cuda).to(dtype) for a in qkv]
        esm_op.esm_flash_attention(*low, pad)  # builds and loads the library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            esm_op.esm_flash_attention(*low, pad)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and want in names[0], (dtype, names)
        assert not_want is None or not_want not in names[0], (dtype, names)


@pytest.mark.gpu
def test_esm_flash_attention_refuses_what_its_kernel_does_not_take(cuda):
    """No fallback: f32 with D = 128 (past the f32 kernel's shared memory),
    D not a multiple of 8 and a CPU padding mask raise."""
    for dtype, d, pad_dev in ((torch.float32, 128, cuda),
                              (torch.bfloat16, 20, cuda),
                              (torch.bfloat16, 64, 'cpu')):
        qkv, pad = _esm_case(17, 1, 2, 40, d, True)
        qkv = [a.to(cuda).to(dtype) for a in qkv]
        with pytest.raises(ValueError, match='esm_flash_attention'):
            esm_op.esm_flash_attention(*qkv, pad.to(pad_dev))


# --- ESM2's LayerNorm (csrc/esm_layer_norm.cu) ------------------------------

# (shape, x dtype, eps): ESM2-3B's design batch (16 x 306 rows of 2560), a
# ragged t12-width case in f32, D = 64 (the tiny config) in both dtypes,
# D = 5120 (ESM2 15B: two warps a row in bf16, four in f32), and an f32
# row of 2560 (two warps a row).
ESM_LN_CASES = [((16, 306, 2560), torch.bfloat16, 1e-5),
                ((3, 7, 480), torch.float32, 1e-6),
                ((5, 64), torch.bfloat16, 1e-6),
                ((5, 64), torch.float32, 1e-5),
                ((2, 9, 5120), torch.bfloat16, 1e-5),
                ((2, 9, 5120), torch.float32, 1e-6),
                ((3, 11, 2560), torch.float32, 1e-5)]


def _esm_ln_case(seed, shape, dtype, device):
    """x with an offset mean (a residual stream), scale near 1, in dtype."""
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    w = 1.0 + 0.1 * torch.randn(d, generator=g)
    b = 0.1 * torch.randn(d, generator=g)
    return [a.to(device).to(dtype) for a in (x, w, b)]


@pytest.mark.gpu
@pytest.mark.parametrize('case', ESM_LN_CASES)
def test_esm_layer_norm_kernel_matches_plain(cuda, case):
    """The kernel against the plain version on the same operands: bf16
    within one bf16 step of the larger of the two outputs (the step taken
    no finer than at 2^-8 max|ref|: the f32 sums run in another order than
    torch's, which moves an output before its rounding by ~1e-7 of max|ref|,
    more than a step of an output that close to 0); f32 to 1e-5 max|ref|.
    A second call gives the same bits."""
    shape, dtype, eps = case
    x, w, b = _esm_ln_case(19, shape, dtype, cuda)
    want = esm_ln_op.esm_layer_norm_plain(x, w, b, eps, dtype).float()
    got = esm_ln_op.esm_layer_norm(x, w, b, eps, dtype)
    again = esm_ln_op.esm_layer_norm(x, w, b, eps, dtype)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, again)
    got, top = got.float(), want.abs().max()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 1e-5 * top
    else:
        mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                            top * 2.0 ** -8)
        step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent
                           - 8)
        assert ((got - want).abs() <= step).all()


@pytest.mark.gpu
def test_esm_layer_norm_launches_one_kernel(cuda):
    """One call is one device kernel, `esm_layer_norm_kernel`, and one
    `launches` increment (profiled in a process of its own)."""
    _in_own_process(_esm_layer_norm_launches_one_kernel)


def _esm_layer_norm_launches_one_kernel():
    from torch.profiler import ProfilerActivity, profile
    cuda = _card()
    x, w, b = _esm_ln_case(22, (16, 306, 2560), torch.bfloat16, cuda)
    esm_ln_op.esm_layer_norm(x, w, b, 1e-5, x.dtype)  # builds the library
    torch.cuda.synchronize()
    before = esm_ln_op.esm_layer_norm.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        esm_ln_op.esm_layer_norm(x, w, b, 1e-5, x.dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and 'esm_layer_norm_kernel' in names[0], names
    assert esm_ln_op.esm_layer_norm.launches == before + 1


@pytest.mark.gpu
def test_esm2_3b_forward_launches_the_layer_norm_73_times(cuda,
                                                         monkeypatch):
    """An ESM2-3B-width bf16 forward in eval mode (random weights made on
    the card) launches the kernel once a LayerNorm: 2 x 36 + 1; its final
    representation is within the bf16 bar of the plain route's (the same
    module with the wrapper swapped for its plain version)."""
    from abx_tpu_torch.models import esm as port_esm
    cfg = port_esm.ESM2Config.t36_3B()
    esm = port_esm.ESM2(cfg, torch.bfloat16, device='meta').to_empty(
        device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for name, p in esm.named_parameters():
            p.normal_(1.0 if 'layer_norm.weight' in name else 0.0, 0.02,
                      generator=g)
    tokens = torch.randint(4, 24, (2, 40), device=cuda)
    tokens[:, 0] = port_esm.ESM_CLS
    tokens[:, -1] = port_esm.ESM_EOS
    before = esm_ln_op.esm_layer_norm.launches
    with torch.no_grad():
        got = esm(tokens, final_only=True)
        torch.cuda.synchronize()
        assert esm_ln_op.esm_layer_norm.launches - before == \
            2 * cfg.num_layers + 1
        monkeypatch.setattr(port_esm, 'esm_layer_norm',
                            esm_ln_op.esm_layer_norm_plain)
        want = esm(tokens, final_only=True)
    assert esm_ln_op.esm_layer_norm.launches - before == \
        2 * cfg.num_layers + 1
    _close_on_card(got, want.float(), torch.bfloat16)


@pytest.mark.gpu
def test_esm_layer_norm_refuses_what_its_kernel_does_not_take(cuda):
    """No fallback: D not a multiple of 8, D past 5120, float16, a weight
    or an output dtype other than x's, a CPU weight and a non-contiguous x
    raise."""
    x, w, b = _esm_ln_case(23, (4, 64), torch.bfloat16, cuda)
    strided = x.repeat(1, 2)[:, ::2]
    x20, w20, b20 = _esm_ln_case(23, (4, 20), torch.bfloat16, cuda)
    xw, ww, bw = _esm_ln_case(23, (2, 5128), torch.bfloat16, cuda)
    for args in ((x20, w20, b20, torch.bfloat16),
                 (xw, ww, bw, torch.bfloat16),
                 (x.half(), w.half(), b.half(), torch.float16),
                 (x, w.float(), b.float(), torch.bfloat16),
                 (x, w, b, torch.float32),
                 (x, w.cpu(), b, torch.bfloat16),
                 (strided, w, b, torch.bfloat16)):
        with pytest.raises(ValueError, match='esm_layer_norm'):
            esm_ln_op.esm_layer_norm(args[0], args[1], args[2], 1e-5,
                                     args[3])


# --- the opt-in kernels: ragged L, both orientations, f32 and bf16 ----------

@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_pre_no_fgate_kernel_matches_plain(cuda, shape, dtype):
    x, s, lb, w, wb, mask = _no_fgate(_tri_mult_pre_case(16, *shape))
    f32, low = _on_card((x, s, lb, w.T.copy(), wb, mask), cuda, dtype, {0})
    want = tri_mult_op.tri_mult_pre_plain(*f32, emit_fgate=False)
    got = tri_mult_op.tri_mult_pre(*low, emit_fgate=False)
    torch.cuda.synchronize()
    assert len(got) == 2
    for g, w_ in zip(got, want):
        _close_on_card(g, w_, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_post_gatefold_kernel_matches_plain(cuda, shape, dtype):
    b, l, c, nc = shape
    y, s, lb, w, wb, xs, xb, wg, wgb, res = _gatefold_case(17, b, l, nc, c)
    f32, low = _on_card((y, s, lb, w.T.copy(), wb, xs, xb, wg.T.copy(), wgb,
                         res), cuda, dtype, {0, 9})
    want = tri_mult_op.tri_mult_post_gatefold_plain(*f32)
    got = tri_mult_op.tri_mult_post_gatefold(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


# (b, l, c, nc): C of three, two and three 64-column chunks (136: a ragged
# last chunk), nc of two and one atoms (72: a ragged K atom), M not a
# multiple of the 64-row tile.
GATEFOLD_SHAPES = [(1, 45, 192, 128), (2, 23, 128, 64), (1, 30, 136, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', GATEFOLD_SHAPES)
def test_gatefold_hopper_matches_plain(cuda, shape, dtype):
    """bf16 takes csrc/gatefold_sm90.cu, f32 the tile kernel."""
    b, l, c, nc = shape
    case = _gatefold_case(35, b, l, nc, c)
    f32 = _gatefold_args(case, torch.float32, cuda)
    low = _gatefold_args(case, dtype, cuda)
    assert tri_mult_op.gatefold_hopper_route(low[0], low[-1]) == (
        dtype == torch.bfloat16)
    want = tri_mult_op.tri_mult_post_gatefold_plain(*f32)
    got = tri_mult_op.tri_mult_post_gatefold(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 9, 37, 48, 40), (1, 1, 21, 200, 72)])
def test_gate_proj_kernel_matches_plain(cuda, shape, dtype):
    """(b, r, l, hd, c): r != l, HD above one 64-wide K chunk with a ragged
    last chunk, C below and above one 128-wide N tile."""
    y, g, w, wb, res = _gate_proj_case(18, *shape)
    f32, low = _on_card((y, g, w.T.copy(), wb, res), cuda, dtype, {0, 1, 4})
    want = gate_proj_op.gate_proj_residual_plain(*f32)
    got = gate_proj_op.gate_proj_residual(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 20, 9, 200), (1, 3, 11, 36),
                                   (1, 12, 6, 192)])
def test_ipa_pair_attend_split_matches_plain(shape, dtype):
    """(b, h, l, c) past one launch's limits (H = 20 > 16, C = 200 > 192;
    C = 36 not a multiple of 8) and the flagship H, C (one call, as
    given): the split's launches, each within the kernel's limits, put
    together equal the plain version on the whole."""
    attn, pair = (t(a) for a in _ipa_attend_case(23, *shape))
    pair = pair.to(dtype)
    calls = []

    def launch(a, p):
        assert a.shape[1] <= ipa_attend_op.MAX_HEADS
        assert p.shape[-1] <= ipa_attend_op.MAX_C and p.shape[-1] % 8 == 0
        assert a.is_contiguous() and p.is_contiguous()
        calls.append((a.shape[1], p.shape[-1]))
        return ipa_attend_op.ipa_pair_attend_plain(a, p)
    got = ipa_attend_op.split_pair_attend(attn, pair, launch)
    want = ipa_attend_op.ipa_pair_attend_plain(attn, pair)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert calls == {(2, 20, 9, 200): [(10, 104), (10, 104), (10, 96),
                                       (10, 96)],
                     (1, 3, 11, 36): [(3, 40)],
                     (1, 12, 6, 192): [(12, 192)]}[shape]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 20, 37, 200), (1, 12, 70, 36),
                                   (1, 3, 9, 20)])
def test_ipa_pair_attend_kernel_takes_every_h_and_c(cuda, shape, dtype):
    """Shapes past one launch's limits reach the kernel (several launches),
    never the plain version."""
    attn, pair = (t(a).to(cuda) for a in _ipa_attend_case(29, *shape))
    want = ipa_attend_op.ipa_pair_attend_plain(attn, pair)
    before = ipa_attend_op.ipa_pair_attend.launches
    got = ipa_attend_op.ipa_pair_attend(attn, pair.to(dtype))
    torch.cuda.synchronize()
    assert ipa_attend_op.ipa_pair_attend.launches > before
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 12, 37, 128), (1, 5, 70, 24),
                                   (1, 16, 9, 136), (4, 12, 288, 128),
                                   (4, 16, 287, 128)])
def test_ipa_pair_attend_kernel_matches_plain(cuda, shape, dtype):
    """(b, h, l, c): ragged L (287: attention rows not 16-byte aligned),
    H below and at 16, C below, at and above 128 (136: a warp's second pair
    of n8 tiles, half of it past C), and the flagship shape.  The bf16
    route rounds attn to bf16 as the plain version does."""
    attn, pair = (t(a).to(cuda) for a in _ipa_attend_case(19, *shape))
    want = ipa_attend_op.ipa_pair_attend_plain(attn, pair)
    got = ipa_attend_op.ipa_pair_attend(attn, pair.to(dtype))
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('per_row', [True, False])
@pytest.mark.parametrize('shape', [(2, 37, 24), (1, 70, 16), (1, 33, 20),
                                   (1, 97, 40), (1, 96, 128)])
def test_triangle_multiply_kernel_matches_plain(cuda, shape, per_row,
                                                dtype):
    """(b, l, c): L below, at and not a multiple of the 48-wide tile (97 =
    2 * 48 + 1) or of the 16-wide k step, C a multiple of the 16-channel
    block, above it, not a multiple of 8 (20: the wrapper pads the input
    vectors) and 128, the flagship's."""
    left, right = (t(a).to(cuda) for a in _triangle_case(20, *shape))
    want = triangle_op.triangle_multiply_einsum(left, right, per_row)
    got = triangle_op.triangle_multiply_kernel(left.to(dtype),
                                               right.to(dtype), per_row)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


# --- channel-major triangle multiplication, rows 13 and 14, bf16 exponent --

@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_pre_c_major_kernel_matches_plain(cuda, shape, dtype):
    """Odd L: 64-row tiles straddle two batch elements (2 * 37 * 37)."""
    x, s, lb, w, wb, mask = _tri_mult_pre_case(30, *shape)
    f32, low = _on_card((x, s, lb, w.T.copy(), wb, mask), cuda, dtype, {0})
    want = tri_mult_op.tri_mult_pre_plain(*f32, c_major=True)
    got = tri_mult_op.tri_mult_pre(*low, c_major=True)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _close_on_card(g, w_, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRI_MULT_SHAPES)
def test_tri_mult_post_c_major_kernel_matches_plain(cuda, shape, dtype):
    b, l, c, nc = shape
    y, s, lb, w, wb, fg, res = _tri_mult_post_case(31, b, l, nc, c)
    y = np.ascontiguousarray(y.transpose(0, 3, 1, 2))
    f32, low = _on_card((y, s, lb, w.T.copy(), wb, fg, res), cuda, dtype,
                        {0, 5, 6})
    want = tri_mult_op.tri_mult_post_plain(*f32, y_c_major=True)
    got = tri_mult_op.tri_mult_post(*low, y_c_major=True)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


def _post_c_major_args(shape, dev, dtype, seed=36):
    """(b, l, c, nc) tri_mult_post arguments with y channel-major, made on
    `dev` from a seed (the flagship shape is too large for numpy to make
    quickly), y, fg and res in `dtype`."""
    b, l, c, nc = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sh, scale=1.0):
        return torch.randn(sh, generator=g, device=dev) * scale
    y, fg, res = rnd(b, nc, l, l), rnd(b, l, l, c), rnd(b, l, l, c)
    params = (1 + rnd(nc, scale=0.1), rnd(nc, scale=0.1),
              rnd(c, nc, scale=nc ** -0.5), rnd(c, scale=0.1))
    return (y.to(dtype), *params, fg.to(dtype), res.to(dtype))


# (b, l, c, nc): the flagship; L = 284 (R*L a multiple of 8, not of 64: a
# partial last tile in each batch element); C of three 64-column chunks
# with a ragged last one (136) and nc of two K atoms with a ragged one (72).
POST_C_MAJOR_SHAPES = [(4, 288, 192, 128), (2, 284, 192, 128),
                       (2, 20, 136, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', POST_C_MAJOR_SHAPES)
def test_post_c_major_hopper_matches_plain(cuda, shape, dtype):
    """bf16 takes csrc/post_cmajor_sm90.cu, f32 the tile kernel."""
    f32 = _post_c_major_args(shape, cuda, torch.float32)
    low = _post_c_major_args(shape, cuda, dtype)
    assert tri_mult_op.post_c_major_hopper_route(low[0], low[-1]) == (
        dtype == torch.bfloat16)
    want = tri_mult_op.tri_mult_post_plain(*f32, y_c_major=True)
    got = tri_mult_op.tri_mult_post(*low, y_c_major=True)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.parametrize('dtype,nc,c,l,want', [
    (torch.bfloat16, 128, 192, 288, True), (torch.bfloat16, 72, 136, 20, True),
    (torch.bfloat16, 128, 192, 284, True), (torch.float32, 128, 192, 288, False),
    (torch.bfloat16, 128, 192, 37, False), (torch.bfloat16, 136, 192, 288, False),
    (torch.bfloat16, 128, 200, 288, False), (torch.bfloat16, 44, 192, 288, False),
    (torch.bfloat16, 128, 36, 288, False)])
def test_post_c_major_route_is_decided_by_dtype_and_shape(dtype, nc, c, l,
                                                          want):
    """The channel-major post takes the Hopper kernel for bf16 with nc <=
    128 and C <= 192, both multiples of 8, and L*L a multiple of 8 (37 * 37
    is not); f32 and other shapes the tile kernel."""
    y = torch.zeros(1, nc, l, l, dtype=dtype)
    res = torch.zeros(1, l, l, c, dtype=dtype)
    assert tri_mult_op.post_c_major_hopper_route(y, res) == want


@pytest.mark.gpu
@pytest.mark.parametrize('per_row', [True, False])
def test_triangle_multiply_c_major_matches_einsum(cuda, per_row):
    left, right = (t(a).to(cuda) for a in _triangle_case(32, 2, 37, 24))
    want = triangle_op.triangle_multiply_einsum(left, right, per_row)
    got = triangle_op.triangle_multiply_c_major(
        left.permute(0, 3, 1, 2).contiguous(),
        right.permute(0, 3, 1, 2).contiguous(), per_row)
    _close_on_card(got.permute(0, 2, 3, 1), want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 5, 3, 70, 48), (1, 3, 2, 37, 17),
                                   (1, 3, 4, 288, 48), (1, 2, 2, 100, 17)])
def test_triangle_attention_fused_kernel_matches_plain(cuda, shape, dtype):
    """(b, r, h, l, d): ragged L, D = 48 and D = 17 (padded to 32, its
    34-byte rows staged element by element), and L = 288 with R = 3 rows
    (a block's second row group spare in the last block)."""
    f32, low = _on_card(_fused_case(33, *shape), cuda, dtype, {0, 1, 2})
    want = tri_op.triangle_attention_fused_plain(*f32)
    got = tri_op.triangle_attention_fused(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('flag', ['1', '0'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 37, 48, 4), (1, 70, 32, 2),
                                   (1, 130, 32, 2)])
def test_triangle_attention_packed_cols_kernel_matches_plain(
        cuda, monkeypatch, shape, dtype, flag):
    """(b, l, c, h): ragged L, L above one 64-query block, and L = 130
    above one query tile of either height (64 or 96); the bf16 kernel
    against the plain version with the exponent it takes."""
    monkeypatch.setenv('ABX_TRI_ATTN_BF16_EXP', flag)
    case = _cols_case(34, *shape)
    x, s, lb, wq, wk, wv, wg, bg, bias, mask = (t(a).to(cuda) for a in case)
    w = [a.T.contiguous() for a in (wq, wk, wv, wg)]
    bf16_exp = dtype == torch.bfloat16 and flag == '1'
    want = tri_op.triangle_attention_packed_cols_plain(
        x, s, lb, *w[:3], w[3], bg, bias, mask, bf16_exp=bf16_exp)
    got = tri_op.triangle_attention_packed_cols(
        x.to(dtype), s, lb, *w[:3], w[3], bg, bias, mask)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('flag', ['1', '0'])
@pytest.mark.parametrize('shape', [(2, 7, 70, 4, 48), (2, 1, 13, 4, 17)])
def test_tri_attention_bf16_exp_flag_matches_plain(cuda, monkeypatch, shape,
                                                   flag):
    """The bf16 packed kernel, tri and seq shapes, under
    ABX_TRI_ATTN_BF16_EXP on and off, against the plain version with the
    same exponent."""
    monkeypatch.setenv('ABX_TRI_ATTN_BF16_EXP', flag)
    b, r, l, h, d = shape
    k = _tri_case(35, b, r, l, h, d, h * d, 'per_row')
    wq, wk, wv, wg = (t(w.T).to(cuda) for w in k['w'])
    kw = dict(ln=(t(k['scale']).to(cuda), t(k['lnb']).to(cuda)),
              gate=(wg, t(k['bg']).to(cuda)),
              out_proj=(t(k['wo'].T).to(cuda), t(k['bo']).to(cuda)))
    x, bias, mask, res = (t(k[n]).to(cuda) for n in ('x', 'bias', 'mask',
                                                     'res'))
    want = tri_op.triangle_attention_packed_plain(
        x, wq, wk, wv, bias, mask, residual=res, bf16_exp=flag == '1', **kw)
    got = tri_op.triangle_attention_packed(
        x.bfloat16(), wq, wk, wv, bias, mask, residual=res.bfloat16(), **kw)
    torch.cuda.synchronize()
    _close_on_card(got, want, torch.bfloat16)


# --- the core's bf16 exponent: taken against the row's final max -----------

EXP_TOL = 1e-2   # max |got - want| / want over the outputs of _exp_case


def _exp_case(seed, b, r, l, h, d, columns=False):
    """Projection rows y (B*R*L, 3*H*D) [q | k | v], bias (B, H, L, L) and
    key mask (B, L), all exact in bf16, for the attention core with the
    bf16 exponent.  q (multiples of 1/4 in [-2, 2]), k (of 1/8 in [-1, 1])
    and the bias (of 1/64 in [-2, 4]) make q . k + bias exact in f32 in
    any order of summation, so the kernel and the plain core see the same
    logits and the same bf16(s - m).  The bias is 2 higher on keys >= 64,
    so each row's max lies past the first 64-key tile, where a running max
    still differs from the final one.  v is one-hot, v[j, e] = [j mod D ==
    e] in every head, so each output is a sum of probabilities (none 0:
    one key is masked), which the bf16 rounding of the output (2^-8
    relative at most) does not hide.  With `columns` position l of column
    i is row (b*L + l)*L + i (R == L)."""
    rng = np.random.default_rng(seed)
    n = b * r * l
    pos = (np.arange(n) // l) % l if columns else np.arange(n) % l
    q = rng.integers(-8, 9, (n, h, d)) / 4
    k = rng.integers(-8, 9, (n, h, d)) / 8
    v = np.broadcast_to((pos[:, None] % d == np.arange(d))[:, None],
                        (n, h, d))
    y = np.concatenate([a.reshape(n, h * d) for a in (q, k, v)], 1)
    bias = rng.integers(-128, 129, (b, h, l, l)) / 64
    bias[..., 64:] += 2.0
    mask = np.ones((b, l))
    mask[:, 5] = 0.0
    out = [a.astype(np.float32) for a in (y, bias, mask)]
    for a in out[:2]:
        assert np.array_equal(t(a).bfloat16().float().numpy(), a)
    return out


def _exp_err(got, want):
    """max |got - want| / want (every want of _exp_case is positive)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert (want > 0).all()
    return ((got - want).abs() / want).max().item()


def _final_max_core(y, shape, bias, mask, columns=False):
    """The attention core without a gate, in f32 on y's device, with the TPU
    kernel's exponent (`softmax_bf16_exp`: against the row's final max):
    the yardstick of the exponent test."""
    b, r, l, h, d = shape
    hd = h * d
    yf = y.float().reshape(b, r, l, -1)
    if columns:
        yf = yf.transpose(1, 2)
    q, k, v = (yf[..., i * hd:(i + 1) * hd].reshape(b, r, l, h, d)
               .transpose(2, 3) for i in range(3))
    maskbias = (1.0 - mask) * tri_op.BIG_NEG
    s = (q @ k.transpose(-1, -2) + bias.float()[:, None]
         + maskbias[:, None, None, None, :])
    out = (tri_op.softmax_bf16_exp(s) @ v).transpose(2, 3).reshape(
        b, r, l, hd)
    if columns:
        out = out.transpose(1, 2)
    return out.reshape(b * r * l, hd)


def _running_max_core(y, shape, bias, mask, columns=False):
    """What the port's core computed before it took the final max: per
    64-key tile, p = bf16(exp(bf16(s - m_run))) with m_run the running max
    of the row, the sum and P V rescaled by exp(m_old - m_new); the output
    rounded to bf16.  f32 on the CPU."""
    b, r, l, h, d = shape
    hd = h * d
    yf = y.float().reshape(b, r, l, -1)
    if columns:
        yf = yf.transpose(1, 2)
    q, k, v = (yf[..., i * hd:(i + 1) * hd].reshape(b, r, l, h, d)
               .transpose(2, 3) for i in range(3))
    maskbias = (1.0 - mask) * tri_op.BIG_NEG
    s = (q @ k.transpose(-1, -2) + bias[:, None]
         + maskbias[:, None, None, None, :])
    m = torch.full(s.shape[:-1] + (1,), -float('inf'))
    den = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, l, 64):
        blk = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        p = torch.exp((blk - m_new).bfloat16().float()).bfloat16().float()
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p @ v[..., k0:k0 + 64, :]
        m = m_new
    out = (o / den).transpose(2, 3).reshape(b, r, l, hd)
    if columns:
        out = out.transpose(1, 2)
    return out.reshape(b * r * l, hd).bfloat16()


@pytest.mark.parametrize('columns', [False, True])
def test_exponent_case_resolves_the_running_max(columns):
    """On the CPU: with the tolerance of the gpu exponent test, the core's
    old running-max exponent fails the case and the final-max plain core,
    rounded to bf16 as the kernel's output is, passes it with room."""
    shape = (1, 72, 72, 2, 16) if columns else (1, 3, 130, 2, 16)
    y, bias, mask = (t(a) for a in _exp_case(50, *shape, columns=columns))
    want = _final_max_core(y, shape, bias, mask, columns)
    torch.testing.assert_close(
        tri_op.tri_attention_core_plain(y, shape, bias, mask, False,
                                        bf16_exp=True, columns=columns),
        want, rtol=1e-6, atol=1e-7)
    assert _exp_err(want.bfloat16(), want) <= EXP_TOL / 2
    old = _running_max_core(y, shape, bias, mask, columns)
    assert _exp_err(old, want) > 2 * EXP_TOL


@pytest.mark.parametrize('bf16_exp', [True, False])
@pytest.mark.parametrize('columns', [False, True])
def test_tri_attention_core_plain_composes_the_packed_plain(columns,
                                                            bf16_exp):
    """On the CPU: LN + the fused [q*D^-1/2 | k | v | gate] projection,
    then the plain core, is the packed plain version, over rows and over
    columns; the core's wrapper takes the plain version for a CPU tensor,
    with the bf16 exponent for bf16 inputs only (these are f32)."""
    b, l, h, d = 2, 11, 2, 8
    c = h * d
    k = _tri_case(51, b, l, l, h, d, c, 'per_row')
    x, bias, mask = t(k['x']), t(k['bias']), t(k['mask'])
    wq, wk, wv, wg = (t(w.T) for w in k['w'])
    ln = (t(k['scale']), t(k['lnb']))
    xin = x.transpose(1, 2) if columns else x
    xn = tri_op.layer_norm(xin, *ln)
    w_all = torch.cat([wq * d ** -0.5, wk, wv, wg])
    b_all = torch.cat([torch.zeros(3 * c), t(k['bg'])])
    y = torch.nn.functional.linear(xn, w_all, b_all)
    if columns:
        y = y.transpose(1, 2)
    y, shape = y.reshape(b * l * l, 4 * c), (b, l, l, h, d)
    got = tri_op.tri_attention_core_plain(y, shape, bias, mask, True,
                                          bf16_exp, columns)
    torch.testing.assert_close(
        tri_op.tri_attention_core(y, shape, bias, mask, True, bf16_exp,
                                  columns),
        tri_op.tri_attention_core_plain(y, shape, bias, mask, True, False,
                                        columns))
    want = tri_op.triangle_attention_packed_plain(
        xin, wq, wk, wv, bias, mask, ln=ln, gate=(wg, t(k['bg'])),
        bf16_exp=bf16_exp)
    if columns:
        want = want.transpose(1, 2)
    torch.testing.assert_close(got.reshape(b, l, l, c), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('columns', [False, True])
def test_tri_attention_core_takes_the_final_max(cuda, columns):
    """The bf16 core through its C entry on the rows of _exp_case (L = 160
    over three 64-key tiles, D = 48, R = 3 rows against blocks of two;
    columns at L = 136), against the plain core with the TPU kernel's
    exponent on the same values, to EXP_TOL.  A running-max core fails
    it (the CPU test above); the core before it took the final max did, on
    the card."""
    shape = (1, 136, 136, 2, 16) if columns else (1, 3, 160, 2, 48)
    b, r, l, h, d = shape
    y, bias, mask = (t(a).to(cuda) for a in _exp_case(
        52, *shape, columns=columns))
    want = _final_max_core(y, shape, bias, mask, columns)
    y16, bias16 = y.bfloat16(), bias.bfloat16()
    got = torch.empty((b * r * l, h * d), dtype=torch.bfloat16, device=cuda)
    _lib.check(_lib.lib().abx_tri_attention_core(
        1, y16.data_ptr(), 3 * h * d, b, r, l, h, d, bias16.data_ptr(),
        mask.data_ptr(), 0, 1, int(columns), got.data_ptr(),
        _lib.stream(y16)), 'abx_tri_attention_core')
    torch.cuda.synchronize()
    err = _exp_err(got, want)
    print(f'final-max exponent, columns={columns}: max rel err {err:.3g}')
    assert err <= EXP_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['rows-exp-1', 'rows-exp-0', 'fused'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tri_attention_fully_masked_key_row_matches_plain(cuda, monkeypatch,
                                                          kind, dtype):
    """A batch element whose every key is masked: its logits all round to
    BIG_NEG in f32 and its softmax is uniform, in the kernels as in the
    plain versions."""
    if kind == 'fused':
        f32, low = _on_card(_fused_case(53, 2, 3, 2, 70, 48), cuda, dtype,
                            {0, 1, 2})
        f32[4][1] = 0.0
        want = tri_op.triangle_attention_fused_plain(*f32)
        got = tri_op.triangle_attention_fused(*low[:4], f32[4])
    else:
        flag = kind[-1]
        monkeypatch.setenv('ABX_TRI_ATTN_BF16_EXP', flag)
        k = _tri_case(53, 2, 3, 70, 4, 48, 192, 'per_row')
        k['mask'][1] = 0.0
        wq, wk, wv, wg = (t(w.T).to(cuda) for w in k['w'])
        kw = dict(ln=(t(k['scale']).to(cuda), t(k['lnb']).to(cuda)),
                  gate=(wg, t(k['bg']).to(cuda)))
        x, bias, mask = (t(k[n]).to(cuda) for n in ('x', 'bias', 'mask'))
        want = tri_op.triangle_attention_packed_plain(
            x, wq, wk, wv, bias, mask,
            bf16_exp=dtype == torch.bfloat16 and flag == '1', **kw)
        got = tri_op.triangle_attention_packed(x.to(dtype), wq, wk, wv,
                                               bias, mask, **kw)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


# --- the IPA scalar attend takes p in the input dtype ----------------------

IPA_CANCEL_TOL = 1e-2   # max |got - want| / |want| over out_s


def _ipa_cancel_case(b=1, l=37, h=3, c=32):
    """The ten ipa_attention inputs (numpy f32) of a case whose scalar
    attend cancels: every query row of head h puts nearly all its weight on
    keys 0 and 1 (bias 4 and 4 - gap_h, every other key -30; scalar and
    point terms 0), whose values are +1 and -1 in every dim, so each out_s
    element is p_0 - p_1 ~ gap_h / 2.  Rounding p to bf16 before the attend
    moves that difference by 15-35%: the gaps are chosen so that p_0 and
    p_1 lie at least 0.2 bf16 ulp from a rounding midpoint, which f32 noise
    in the logits cannot cross.  The pair track is random."""
    rng = np.random.default_rng(60)
    f = np.float32
    gaps = np.array([0.0132816, 0.0179590, 0.0133092], f)[:h]
    qs = np.zeros((b, l, h, 16), f)
    vs = np.zeros((b, l, h, 16), f)
    vs[:, 0], vs[:, 1] = 1.0, -1.0
    pts = [np.zeros((b, l, h, p, 3), f) for p in (4, 4, 8)]
    bias = np.full((b, h, l, l), -30.0, f)
    bias[..., 0] = 4.0
    bias[..., 1] = (4.0 - gaps)[None, :, None]
    return [qs, qs.copy(), vs, *pts, np.full(h, -0.1, f), bias,
            np.ones((b, l), f), rng.standard_normal((b, l, l, c)).astype(f)]


def _cancel_err(got, want):
    """max |got - want| / |want| over out_s (no want is 0 here)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert (want.abs() > 0).all()
    return ((got - want).abs() / want.abs()).max().item()


def _ipa_cancel_inputs(case, dtype, dev='cpu'):
    """The case on `dev`: q / k / v and the pair in dtype, the rest f32."""
    return [t(a).to(dev).to(dtype) if i in (0, 1, 2, 9) else t(a).to(dev)
            for i, a in enumerate(case)]


def test_ipa_cancel_case_tells_bf16_p_from_f32_p():
    """On the CPU: the plain version in bf16 (p rounded to bf16 before the
    scalar attend, as the TPU kernel does) against an emulation that keeps
    p in f32 (the scalar attend of the kernel's first design): at IPA_CANCEL_TOL the
    emulation fails the case by far, and the plain output's own bf16
    rounding stays well inside it."""
    args = _ipa_cancel_inputs(_ipa_cancel_case(), torch.bfloat16)
    want = ipa_op.ipa_attention_plain(*args)[0]
    f32 = [a.float() for a in args]
    logits = f32[7] + ((1.0 - f32[8]) * ipa_op.BIG_NEG)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    b, l, h, ds = args[0].shape
    exact = torch.einsum('bhij,bjhd->bihd', probs.bfloat16().float(),
                         f32[2]).reshape(b, l, h * ds)
    f32_p = torch.einsum('bhij,bjhd->bihd', probs, f32[2]).reshape(
        b, l, h * ds).bfloat16()
    assert _cancel_err(want, exact) <= IPA_CANCEL_TOL / 2
    assert _cancel_err(f32_p, want) > 10 * IPA_CANCEL_TOL


@pytest.mark.gpu
def test_ipa_attention_scalar_attend_rounds_p(cuda):
    """The bf16 kernel on the cancellation case: out_s within
    IPA_CANCEL_TOL of the bf16-p plain version (the f32-p scalar attend of
    an f32-p scalar attend misses it by 15-35%); out_p and out_2d to the usual
    bar."""
    case = _ipa_cancel_case()
    args = _ipa_cancel_inputs(case, torch.bfloat16, cuda)
    want = ipa_op.ipa_attention_plain(*args)
    got = ipa_op.ipa_attention(*args)
    torch.cuda.synchronize()
    err = _cancel_err(got[0], want[0])
    print(f'ipa scalar attend, bf16 p: max rel err {err:.3g}')
    assert err <= IPA_CANCEL_TOL, err
    f32 = ipa_op.ipa_attention_plain(*_ipa_cancel_inputs(case,
                                                         torch.float32, cuda))
    for g, w in zip(got[1:], f32[1:]):
        _close_on_card(g, w, torch.bfloat16)


# (b, l, h, ds, pq, pv, c): L not a multiple of the rows a block or of 16;
# H below 16 and at 12; Ds 16 and 32; C 32, 48 and 128.
IPA_SHAPES = [(2, 37, 3, 16, 4, 8, 32), (1, 70, 12, 16, 4, 8, 128),
              (2, 29, 5, 32, 3, 5, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', IPA_SHAPES)
def test_ipa_attention_ragged_matches_plain(cuda, shape, dtype):
    args = [t(a).to(cuda) for a in _ipa_case(61, *shape)]
    args[8][-1, :] = 0.0
    args[8][-1, 3] = 1.0    # a batch element with one valid key
    want = ipa_op.ipa_attention_plain(*args)
    low = [a.to(dtype) if i in (0, 1, 2, 9) else a
           for i, a in enumerate(args)]
    got = ipa_op.ipa_attention(*low)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close_on_card(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('l', [45, 46])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ipa_attention_takes_the_module_layouts(cuda, dtype, l):
    """k / v as column blocks of one projection, the value points as a
    slice of the key-value points and the bias as the module's permuted
    (B, L, L, H) projection in the compute dtype, one launch a call (in
    bf16 at L = 46 each row's L x H bias is read in 16-byte pieces, at
    L = 45 element by element)."""
    b, h, ds, pq, pv, c = 2, 12, 16, 4, 8, 64
    args = [t(a).to(cuda) for a in _ipa_case(62, b, l, h, ds, pq, pv, c)]
    kv = torch.cat([args[1], args[2]], -1).to(dtype)
    kvp = torch.cat([args[4], args[5]], -2)
    bias = args[7].permute(0, 2, 3, 1).contiguous().to(dtype).permute(
        0, 3, 1, 2)
    strided = [args[0].to(dtype), kv[..., :ds], kv[..., ds:], args[3],
               kvp[..., :pq, :], kvp[..., pq:, :], args[6], bias, args[8],
               args[9].to(dtype)]
    want = ipa_op.ipa_attention_plain(*args[:7], bias.float(), *args[8:])
    before = ipa_op.ipa_attention.launches
    got = ipa_op.ipa_attention(*strided)
    torch.cuda.synchronize()
    assert ipa_op.ipa_attention.launches == before + 1
    for g, w in zip(got, want):
        _close_on_card(g, w, dtype)


# --- the Hopper row-linear core at ragged shapes ---------------------------

# (b, l, c, nc): K = 192 and 128 (three and two swizzle atoms), M not a
# multiple of 128 rows.
SM90_PRE_SHAPES = [(1, 45, 192, 128), (2, 23, 128, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize('c_major', [False, True])
@pytest.mark.parametrize('emit_fgate', [True, False])
@pytest.mark.parametrize('shape', SM90_PRE_SHAPES)
def test_tri_mult_pre_wide_matches_plain(cuda, shape, emit_fgate, c_major):
    if c_major and not emit_fgate:
        pytest.skip('the gate-fold post takes the natural layout only')
    pre = _tri_mult_pre_case(63, *shape)
    if not emit_fgate:
        pre = _no_fgate(pre)
    x, s, lb, w, wb, mask = pre
    f32, low = _on_card((x, s, lb, w.T.copy(), wb, mask), cuda,
                        torch.bfloat16, {0})
    kw = dict(emit_fgate=emit_fgate, c_major=c_major)
    want = tri_mult_op.tri_mult_pre_plain(*f32, **kw)
    got = tri_mult_op.tri_mult_pre(*low, **kw)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        _close_on_card(g, w_, torch.bfloat16)


# --- packed weights: the wrappers' helpers and the modules' cache ----------

def test_pack_pre_matches_pack():
    """pack_pre lays the projections out as _pack does, the final gate's
    rows after the gated chunks, in the compute dtype, the bias f32."""
    x, s, lb, w, wb, mask = _tri_mult_pre_case(64, 1, 5, 8, 72)
    wt, wbt = t(w.T.copy()), t(wb)
    nc = 72
    ws, bs = torch.split(wt, [nc] * 4 + [8]), torch.split(wbt, [nc] * 4 + [8])
    pk = tri_mult_op.pack_pre(ws, bs, t(s), t(lb), torch.bfloat16)
    want = torch.cat([tri_mult_op._pack(ws[0], ws[2]),
                      tri_mult_op._pack(ws[1], ws[3]), ws[4]])
    assert pk.w_packed.dtype == torch.bfloat16
    torch.testing.assert_close(pk.w_packed, want.bfloat16())
    torch.testing.assert_close(pk.b_packed, torch.cat([
        tri_mult_op._pack(bs[0], bs[2]), tri_mult_op._pack(bs[1], bs[3]),
        bs[4]]))
    torch.testing.assert_close(pk.w, wt)
    torch.testing.assert_close(pk.wb, wbt)


def test_pack_projection_folds_the_query_scale():
    k = _tri_case(65, 1, 2, 5, 2, 8, 16, 'per_row')
    wq, wk, wv, wg = (t(w.T) for w in k['w'])
    gate, ln = (wg, t(k['bg'])), (t(k['scale']), t(k['lnb']))
    wo = (t(k['wo'].T), t(k['bo']))
    pk = tri_op.pack_projection(wq, wk, wv, 8, torch.bfloat16, ln=ln,
                                gate=gate, out_proj=wo)
    torch.testing.assert_close(
        pk.w_all, torch.cat([wq * 8 ** -0.5, wk, wv, wg]).bfloat16())
    torch.testing.assert_close(pk.b_all,
                               torch.cat([torch.zeros(48), t(k['bg'])]))
    assert pk.wo.dtype == torch.bfloat16 and pk.bo.dtype == torch.float32
    assert pk.ln_s.dtype == torch.float32
    bare = tri_op.pack_projection(wq, wk, wv, 8, torch.float32)
    assert bare.w_all.shape == (48, 16) and bare.wo is None


def test_weight_cache_rebuilds_on_change():
    """The cache keeps its value while the sources stand still and rebuilds
    it after an in-place write, a replaced tensor or another dtype."""
    from abx_tpu_torch.ops.weight_cache import WeightCache
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.zeros(2))
    cache = WeightCache()

    def get(dtype=torch.float32):
        return cache.get([p, q], dtype, lambda: torch.cat([p, q]).to(dtype))
    first = get()
    assert get() is first and cache.builds == 1
    with torch.no_grad():
        p.mul_(2.0)
    assert get()[0].item() == 2.0 and cache.builds == 2
    get(torch.bfloat16)
    assert cache.builds == 3
    q = torch.nn.Parameter(torch.full((2,), 5.0))
    assert get(torch.bfloat16)[-1].item() == 5.0 and cache.builds == 4


@pytest.mark.gpu
def test_tri_mult_module_cache_follows_an_in_place_change(cuda):
    """The triangle multiplication on the card (bf16, kernel route) after
    one of its weights is changed in place: the packed weights are rebuilt,
    and the module's output follows its plain route (ABX_FUSED_TRIMULT=0)
    on the new weights."""
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.models.seqformer import TriangleMultiplication
    cfg = config_lib.tiny_model_config()
    tm_cfg = cfg.model.embeddings_and_seqformer.seqformer\
        .triangle_multiplication_outgoing
    torch.manual_seed(0)
    c = 32
    mod = TriangleMultiplication(tm_cfg, c, dtype=torch.bfloat16).to(
        cuda).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    act = torch.randn(1, 19, 19, c, device=cuda).bfloat16()
    mask = torch.ones(1, 19, device=cuda)
    with torch.no_grad():
        mod(act, mask, residual=True)
        builds = mod._packs[True].builds
        mod.left_gate.weight.mul_(-1.5)
        got = mod(act, mask, residual=True)
    assert mod._packs[True].builds == builds + 1
    import os
    os.environ['ABX_FUSED_TRIMULT'] = '0'
    try:
        with torch.no_grad():
            want = mod(act, mask, residual=True)
    finally:
        os.environ.pop('ABX_FUSED_TRIMULT')
    torch.cuda.synchronize()
    _close_on_card(got, want.float(), torch.bfloat16)


# --- the Hopper transition and pair-bias kernels ----------------------------
# bf16 launches with C <= 192 (a multiple of 8) take csrc/transition_sm90.cu
# and csrc/pair_bias.cu; the others stay on transition.cu and row_linear.cu
# (out_mode 1).  Their plain
# versions keep the TPU kernels' rounding points, which the bf16 checks
# below hold: two results at the same rounding points differ only where an
# f32 sum taken in another order lands on the other side of a bf16 rounding
# (a small share of the outputs), while one rounding point missed moves a
# large share of them (test_bf16_check_resolves_a_missed_rounding_point).

BF16_SHARE = 1e-2    # share of the bf16 outputs that may differ
BF16_STEPS = 2 ** -7  # max |got - want| / max|want|: two bf16 steps


def bf16_agree(got, want):
    """(max |got - want| / max|want|, share of the outputs that differ)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item() / want.abs().max().item(),
            (got != want).float().mean().item())


def transition_missed_rounding(x, s, lb, w1, b1, w2, b2):
    """fused_transition_plain with the hidden activations left in f32: a
    rounding point a kernel that keeps them in registers could skip."""
    import torch.nn.functional as F
    from abx_tpu_torch.models.modules import layer_norm
    dt, x32 = x.dtype, x.float()
    ln = layer_norm(x32, s, lb).to(dt).float()
    h = torch.relu(F.linear(ln, w1.to(dt).float()) + b1)
    y = F.linear(h, w2.to(dt).float()) + b2
    return (y + x32).to(dt)


def pair_bias_missed_rounding(pair, s, lb, w):
    """pair_bias_proj_plain with LN(x) left in f32."""
    import torch.nn.functional as F
    from abx_tpu_torch.models.modules import layer_norm
    dt = pair.dtype
    y = F.linear(layer_norm(pair, s, lb), w.to(dt).float()).to(dt)
    return y.permute(0, 3, 1, 2).contiguous()


def gatefold_missed_rounding(y, s, lb, w, wb, xs, xb, wg, wgb, res):
    """tri_mult_post_gatefold_plain with each product rounded to the input
    dtype before its bias (the JAX `*_reference` twin's rounding, which the
    Pallas kernel does not have)."""
    import torch.nn.functional as F
    from abx_tpu_torch.models.modules import layer_norm
    dt = y.dtype
    o = F.linear(layer_norm(y, s, lb, dtype=dt), w.to(dt)).float() + wb
    fg = F.linear(layer_norm(res, xs, xb, dtype=dt), wg.to(dt)).float() + wgb
    return (o * torch.sigmoid(fg) + res.float()).to(dt)


def _transition_port(case, dtype, dev='cpu'):
    x, s, lb, w1, b1, w2, b2 = (t(a).to(dev) for a in case)
    return x.to(dtype), s, lb, w1.T.contiguous(), b1, w2.T.contiguous(), b2


def _pair_bias_port(case, dtype, dev='cpu'):
    pair, s, lb, w = (t(a).to(dev) for a in case)
    return pair.to(dtype), s, lb, w.T.contiguous()


@pytest.mark.parametrize('kind', ['transition', 'pair_bias', 'gatefold'])
def test_bf16_check_resolves_a_missed_rounding_point(kind):
    """The bf16 check holds the plain version to itself and tells it from
    the same function with one rounding point missed (for the gate-fold:
    the bf16-rounded products of the plain version before its repair)."""
    if kind == 'transition':
        args = _transition_port(_transition_case(9, 1, 8, 16, 64),
                                torch.bfloat16)
        plain, missed = (transition_op.fused_transition_plain,
                         transition_missed_rounding)
    elif kind == 'gatefold':
        args = _gatefold_args(_gatefold_case(9, 1, 16, 64, 48),
                              torch.bfloat16)
        plain, missed = (tri_mult_op.tri_mult_post_gatefold_plain,
                         gatefold_missed_rounding)
    else:
        args = _pair_bias_port(_pair_bias_case(9, 2, 8, 8, 64, 5),
                               torch.bfloat16)
        plain, missed = (pair_bias_op.pair_bias_proj_plain,
                         pair_bias_missed_rounding)
    want = plain(*args)
    assert bf16_agree(plain(*args), want) == (0.0, 0.0)
    err, share = bf16_agree(missed(*args), want)
    assert share > 10 * BF16_SHARE, share


@pytest.mark.parametrize('dtype,c,h,want', [
    (torch.bfloat16, 192, 4, True), (torch.bfloat16, 48, 64, True),
    (torch.float32, 192, 4, False), (torch.bfloat16, 200, 4, False),
    (torch.bfloat16, 44, 4, False), (torch.bfloat16, 192, 65, False)])
def test_hopper_routes_are_decided_by_dtype_and_shape(dtype, c, h, want):
    """bf16 with C <= 192 a multiple of 8 (and H <= 64, N a multiple of 8)
    take the Hopper kernels; f32 and other shapes the generic ones."""
    x = torch.zeros(2, 3, c, dtype=dtype)
    assert pair_bias_op.hopper_route(x, h) == want
    assert transition_op.hopper_route(x, 4 * c) == (want or h == 65)
    assert not transition_op.hopper_route(x, 4 * c + 4)


def _module_case(kind, dev='cpu', dtype=torch.float32):
    """(module, call, its packed-weight cache, the wrapper it calls, the
    submodule and name of a parameter the packed weights hold, and the
    packed tensor made from it) at a tiny size, f32 on the CPU by
    default."""
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.models import seqformer as sf
    cfg = config_lib.tiny_model_config().model.embeddings_and_seqformer
    scfg = cfg.seqformer
    torch.manual_seed(0)
    pair = torch.randn(1, 5, 5, 16).to(dev, dtype)
    mask = torch.ones(1, 5, device=dev)
    if kind == 'transition':
        mod = sf.Transition(scfg.pair_transition, 16)
        return (mod, lambda: mod(pair, residual=True), mod._pack,
                'fused_transition', 'in_proj', 'weight', lambda pk: pk.w1)
    if kind == 'seq_attention':
        mod = sf.SeqAttentionWithPairBias(scfg.seq_attention_with_pair_bias,
                                          8, 16)
        seq = torch.randn(1, 5, 8).to(dev, dtype)
        return (mod, lambda: mod(seq, pair, mask), mod._bias_pack,
                'pair_bias_proj', 'proj_pair', 'weight', lambda pk: pk.w)
    if kind in ('gatefold', 'post'):
        mod = sf.TriangleMultiplication(scfg.triangle_multiplication_outgoing,
                                        16)
        cache, wrapper = ((mod._fold_pack, 'tri_mult_post_gatefold')
                          if kind == 'gatefold'
                          else (mod._post_pack, 'tri_mult_post'))
        return (mod, lambda: mod(pair, mask, residual=True), cache, wrapper,
                'proj_out', 'weight', lambda pk: pk.w)
    if kind == 'recycle':
        mod = sf.EmbeddingAndSeqformer(cfg, 3)
        c = cfg.pair_channel + 2 * cfg.index_embed_size
        static = torch.randn(1, 5, 5, cfg.pair_channel).to(dev, dtype)
        t_embed = torch.randn(1, cfg.index_embed_size).to(dev, dtype)
        batch = {'prev_pair': torch.randn(1, 5, 5, c).to(dev, dtype),
                 'prev_pos': torch.randint(0, cfg.prev_pos.num_bins,
                                           (1, 5, 5)).to(dev)}
        return (mod, lambda: mod._recycled_pair(static, t_embed, batch),
                mod._recycle_pack, 'recycle_embed', 'proj_prev_pos',
                'embedding', lambda pk: pk.table)
    mod = sf.TriangleAttention(scfg.triangle_attention_starting_node, 16)
    return (mod, lambda: mod(pair, mask, residual=True), mod._bias_pack,
            'pair_bias_proj', 'proj_pair', 'weight', lambda pk: pk.w)


@pytest.mark.parametrize('kind', ['transition', 'seq_attention',
                                  'tri_attention', 'gatefold', 'recycle',
                                  'post'])
def test_module_caches_the_packed_weights(monkeypatch, kind):
    """On the kernel route a module packs the kernel's weights once and
    hands them to the wrapper on every call; it packs them anew when a
    parameter is assigned or written in place."""
    from abx_tpu_torch.models import seqformer as sf
    from abx_tpu_torch.ops import registry, tri_attention
    mod, call, cache, wrapper, proj, attr, packed_of = _module_case(kind)
    mod.eval()
    plain = {'fused_transition': transition_op.fused_transition_plain,
             'pair_bias_proj': pair_bias_op.pair_bias_proj_plain,
             'tri_mult_post_gatefold':
                 tri_mult_op.tri_mult_post_gatefold_plain,
             'tri_mult_post': tri_mult_op.tri_mult_post_plain,
             'recycle_embed': recycle_op.recycle_embed_plain}[wrapper]
    seen = []

    def spy(*args, packed=None, **kw):
        seen.append(packed)
        return plain(*args, **kw)
    monkeypatch.setattr(registry, 'on_device', lambda x: True)
    monkeypatch.setenv('ABX_TRIMULT_GATEFOLD',
                       '0' if kind == 'post' else '1')
    monkeypatch.setattr(sf, wrapper, spy)
    monkeypatch.setattr(sf, 'triangle_attention_packed',
                        tri_attention.triangle_attention_packed_plain)
    monkeypatch.setattr(sf, 'tri_mult_pre', tri_mult_op.tri_mult_pre_plain)
    with torch.no_grad():
        call()
        call()
        assert cache.builds == 1 and seen[0] is seen[1]
        weight = getattr(getattr(mod, proj), attr)
        w_new = torch.nn.Parameter(weight.detach() * -2.0)
        setattr(getattr(mod, proj), attr, w_new)
        call()
        assert cache.builds == 2
        torch.testing.assert_close(packed_of(seen[-1]), w_new.detach())
        w_new.mul_(0.5)
        call()
        assert cache.builds == 3
        torch.testing.assert_close(packed_of(seen[-1]), w_new.detach())


TRANSITION_SHAPES = [(2, 5, 70, 48), (1, 7, 37, 192), (1, 3, 45, 40),
                     (1, 2, 80, 136)]
PAIR_BIAS_SHAPES = [(2, 9, 70, 48), (2, 9, 70, 192), (2, 8, 24, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', TRANSITION_SHAPES)
def test_transition_hopper_matches_plain(cuda, shape, dtype):
    """M not a multiple of 128 rows, C of one, two and three 64-column
    atoms (40: a hidden size not a multiple of the 64-wide chunk); bf16
    takes the Hopper kernel, f32 transition.cu's."""
    case = _transition_case(31, *shape)
    f32 = _transition_port(case, torch.float32, cuda)
    low = _transition_port(case, dtype, cuda)
    assert transition_op.hopper_route(low[0], 4 * shape[-1]) == (
        dtype == torch.bfloat16)
    want = transition_op.fused_transition_plain(*f32)
    got = transition_op.fused_transition(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('h', [4, 5, 32, 64])
@pytest.mark.parametrize('shape', PAIR_BIAS_SHAPES)
def test_pair_bias_hopper_matches_plain(cuda, shape, h, dtype):
    """L = 70 with R = 9 (R*L not a multiple of 8: the 128-row tiles cross
    rows r and batch elements b, scalar stores) and R*L = 192 (16-byte
    stores), C of one and three 64-column atoms, H up to 64."""
    case = _pair_bias_case(32, *shape, h)
    f32 = _pair_bias_port(case, torch.float32, cuda)
    low = _pair_bias_port(case, dtype, cuda)
    assert pair_bias_op.hopper_route(low[0], h) == (dtype == torch.bfloat16)
    want = pair_bias_op.pair_bias_proj_plain(*f32)
    got = pair_bias_op.pair_bias_proj(*low)
    torch.cuda.synchronize()
    _close_on_card(got, want, dtype)


def rounding_point_case(kind, dev, seed=33):
    """(wrapper, plain version, bf16 arguments) of a Hopper kernel at a
    shape of several tiles a block: M = 55,296 to 57,600 rows."""
    bf = torch.bfloat16
    if kind == 'transition':
        return (transition_op.fused_transition,
                transition_op.fused_transition_plain,
                _transition_port(_transition_case(seed, 2, 96, 288, 192), bf,
                                 dev))
    if kind == 'pair_bias':
        return (pair_bias_op.pair_bias_proj,
                pair_bias_op.pair_bias_proj_plain,
                _pair_bias_port(_pair_bias_case(seed, 2, 96, 288, 192, 32),
                                bf, dev))
    if kind == 'tri_mult_pre':
        x, s, lb, w, wb, mask = _tri_mult_pre_case(seed, 1, 240, 192, 128)
        f32, low = _on_card((x, s, lb, w.T.copy(), wb, mask), dev, bf, {0})
        return tri_mult_op.tri_mult_pre, tri_mult_op.tri_mult_pre_plain, low
    if kind == 'tri_mult_post':
        case = _tri_mult_post_case(seed, 1, 240, 128, 192)
        y, s, lb, w, wb, fg, res = case
        f32, low = _on_card((y, s, lb, w.T.copy(), wb, fg, res), dev, bf,
                            {0, 5, 6})
        return tri_mult_op.tri_mult_post, tri_mult_op.tri_mult_post_plain, low
    if kind == 'gatefold':
        return (tri_mult_op.tri_mult_post_gatefold,
                tri_mult_op.tri_mult_post_gatefold_plain,
                _gatefold_args(_gatefold_case(seed, 1, 240, 128, 192), bf,
                               dev))
    if kind == 'post_c_major':
        return (functools.partial(tri_mult_op.tri_mult_post, y_c_major=True),
                functools.partial(tri_mult_op.tri_mult_post_plain,
                                  y_c_major=True),
                _post_c_major_args((1, 240, 192, 128), dev, bf, seed))
    if kind == 'ipa_pair_attend':
        attn, pair = (t(a).to(dev) for a in _ipa_attend_case(seed, 2, 12,
                                                             240, 128))
        return (ipa_attend_op.ipa_pair_attend,
                ipa_attend_op.ipa_pair_attend_plain, (attn, pair.to(bf)))
    y, g, w, wb, res = _gate_proj_case(seed, 1, 240, 240, 192, 192)
    f32, low = _on_card((y, g, w.T.copy(), wb, res), dev, bf, {0, 1, 4})
    return (gate_proj_op.gate_proj_residual,
            gate_proj_op.gate_proj_residual_plain, low)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['transition', 'pair_bias', 'tri_mult_pre',
                                  'tri_mult_post', 'gatefold', 'gate_proj',
                                  'post_c_major', 'ipa_pair_attend'])
def test_hopper_kernels_keep_the_rounding_points(cuda, kind):
    """The bf16 kernels against the bf16 plain versions (the TPU kernels'
    rounding points), at the bf16 check's bounds, at a shape of several
    tiles a block; and a second call gives the same bits (a race between
    the kernel's warps would show here)."""
    fn, plain, args = rounding_point_case(kind, cuda)
    want = as_tuple(plain(*args))
    got = as_tuple(fn(*args))
    again = as_tuple(fn(*args))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        err, share = bf16_agree(g, w)
        assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _in_own_process(fn, *args):
    """Run `fn(*args)` in a fresh process (spawned, so with a CUDA context
    of its own) and return its result; an assertion that fails there fails
    here with its message.  The one-launch module tests profile their call
    this way: after the earlier tests of this file, torch.profiler in the
    same process recorded no device event for those calls (`AssertionError:
    []`), though each passed alone, and a profile after every test hid the
    fault; a process of its own gives the profiler the state it has when a
    test runs alone."""
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(1) as pool:
        return pool.apply(fn, args)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['transition', 'seq_attention',
                                  'tri_attention'])
def test_module_launches_the_hopper_kernel_once(cuda, kind):
    """A bf16 call with a module's cached weights launches the Hopper kernel
    alone (the module's transition, or the pair bias as the module computes
    it), and follows an in-place change of a weight (profiled in a process
    of its own)."""
    _in_own_process(_module_launches_the_hopper_kernel_once, kind)


def _module_launches_the_hopper_kernel_once(kind):
    from torch.profiler import ProfilerActivity, profile
    from abx_tpu_torch.models.seqformer import _bias_packed
    cuda = _card()
    mod, _, cache, wrapper, proj, _, _ = _module_case(kind)
    mod = mod.to(cuda).to(torch.bfloat16).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    pair = torch.randn(2, 9, 70, 16, device=cuda).bfloat16()
    ln = mod.pair_norm if kind == 'seq_attention' else getattr(mod, 'norm')
    w = getattr(mod, proj).weight

    def call():
        if kind == 'transition':
            return mod(pair, residual=True)
        return pair_bias_op.pair_bias_proj(
            pair, ln.scale, ln.bias, w,
            packed=_bias_packed(cache, ln, getattr(mod, proj), pair.dtype))

    def plain():
        if kind == 'transition':
            return transition_op.fused_transition_plain(
                pair, ln.scale, ln.bias, mod.in_proj.weight,
                mod.in_proj.bias, mod.out_proj.weight, mod.out_proj.bias)
        return pair_bias_op.pair_bias_proj_plain(pair, ln.scale, ln.bias, w)
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        want = 'transition_sm90' if kind == 'transition' else 'pair_bias'
        assert len(names) == 1 and want in names[0], names
        builds = cache.builds
        getattr(mod, proj).weight.mul_(-1.5)
        got = call()
        assert cache.builds == builds + 1
        torch.cuda.synchronize()
        err, share = bf16_agree(got, plain())
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['gatefold', 'recycle', 'post'])
def test_module_launches_its_kernel_once(cuda, kind):
    """A bf16 call with the module's cached weights launches the kernel
    alone (the gate-fold post and the channel-major post on a contraction
    output, the recycled pair input), and follows an in-place change of a
    weight (profiled in a process of its own)."""
    _in_own_process(_module_launches_its_kernel_once, kind)


def _module_launches_its_kernel_once(kind):
    from torch.profiler import ProfilerActivity, profile
    cuda = _card()
    mod, _, cache, _, proj, attr, _ = _module_case(kind)
    mod = mod.to(cuda).to(torch.bfloat16).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    if kind == 'post':
        nc = mod.final_norm.scale.shape[0]
        y = torch.randn(2, nc, 12, 12, device=cuda).bfloat16()
        fg, res = (torch.randn(2, 12, 12, 16, device=cuda).bfloat16()
                   for _ in range(2))

        def call():
            return tri_mult_op.tri_mult_post(
                y, *mod._post_params(), fg, res, y_c_major=True,
                packed=mod._post_packed(torch.bfloat16))

        def plain():
            return tri_mult_op.tri_mult_post_plain(
                y, *mod._post_params(), fg, res, y_c_major=True)
        want = 'post_cmajor_sm90'
    elif kind == 'gatefold':
        nc = mod.final_norm.scale.shape[0]
        y = torch.randn(2, 9, 9, nc, device=cuda).bfloat16()
        res = torch.randn(2, 9, 9, 16, device=cuda).bfloat16()

        def call():
            return tri_mult_op.tri_mult_post_gatefold(
                y, *mod._fold_params(), res,
                packed=mod._fold_packed(torch.bfloat16))

        def plain():
            return tri_mult_op.tri_mult_post_gatefold_plain(
                y, *mod._fold_params(), res)
        want = 'gatefold_sm90'
    else:
        c, c0 = mod.prev_pair_norm.scale.shape[0], mod.config.pair_channel
        static = torch.randn(2, 9, 9, c0, device=cuda).bfloat16()
        t_embed = torch.randn(2, (c - c0) // 2, device=cuda).bfloat16()
        batch = {'prev_pair': torch.randn(2, 9, 9, c, device=cuda).bfloat16(),
                 'prev_pos': torch.randint(0, 15, (2, 9, 9), device=cuda)}

        def call():
            return mod._recycled_pair(static, t_embed, batch)

        def plain():
            return recycle_op.recycle_embed_plain(
                static, t_embed, batch['prev_pair'],
                mod.prev_pair_norm.scale, mod.prev_pair_norm.bias,
                mod.proj_prev_pos.embedding, batch['prev_pos'])
        want = 'recycle_kernel'
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and want in names[0], names
        builds = cache.builds
        getattr(getattr(mod, proj), attr).mul_(-1.5)
        got = call()
        assert cache.builds == builds + 1
        torch.cuda.synchronize()
        err, share = bf16_agree(got, plain())
    assert err <= BF16_STEPS and share <= BF16_SHARE, (err, share)


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_an_input_that_requires_grad(cuda):
    """On the card a wrapper launched with grad enabled on an input that
    requires grad raises, naming the kernel, where it would return a
    result with no grad_fn; under no_grad it launches."""
    from abx_tpu_torch.ops import transition
    dev = cuda
    g = torch.Generator().manual_seed(0)
    c = 16
    x = torch.randn(1, 5, 5, c, generator=g).to(dev)
    args = [torch.ones(c), torch.zeros(c),
            0.1 * torch.randn(4 * c, c, generator=g), torch.zeros(4 * c),
            0.1 * torch.randn(c, 4 * c, generator=g), torch.zeros(c)]
    args = [a.to(dev).requires_grad_() for a in args]
    with pytest.raises(RuntimeError, match='fused_transition'):
        transition.fused_transition(x, *args)
    with pytest.raises(RuntimeError, match='fused_transition'):
        transition.fused_transition(x.requires_grad_(), *args)
    before = transition.fused_transition.launches
    with torch.no_grad():
        out = transition.fused_transition(x, *args)
    assert transition.fused_transition.launches == before + 1
    assert out.shape == x.shape
