"""What sets the pace of the recycle_embed, gate-fold, channel-major post,
ipa_pair_attend and bf16 flash-route (esm_flash_attention) kernels, by
cutting parts out.

    python -m abx_tpu_torch.tools.ablate_kernels \
        [--out build/ablate_kernels.json] [--kernels NAME ...]

As tools/ablate_transition.py does for the transition: builds variants of
`csrc/recycle_embed.cu`, `csrc/gatefold_sm90.cu`, `csrc/post_cmajor_sm90.cu`,
`csrc/ipa_attend.cu` and `csrc/esm_flash_sm90.cu`, each with one part of
the work removed by a source edit, into libraries of their own (one nvcc
each, all started together; the `-Xptxas -v` report of each is printed),
and times each bare launch at the flagship shape (bf16, B=4, L=288, or the
shape given below; median of CUDA-event
timings after warm-up, and the device time a call from torch.profiler over
20 calls, which leaves out the launch's host work) in turns, twice.  The variants compute wrong values
on purpose; only `full` is checked against the plain version.
recycle_embed ((4,288,288,128) + (4,288,288,192) -> 192):
  full          the kernel as it is;
  no_prefetch   each row group loaded just before it is used (no loads of
                the next group in flight while the current one computes);
  no_ln         no LN moments (no shuffles; mean 0, rstd 1);
  no_table      no table row added;
  no_store      nothing written.
tri_mult_post_gatefold ((4,288,288,128) + res 192 -> 192):
  full          the kernel as it is;
  no_gate_gemm  the gate product left out (gate from its bias alone);
  no_gemm       both products left out;
  no_ln         neither tile normalised;
  no_store      the staged output never written out.
tri_mult_post_c_major ((4,128,288,288) -> (4,288,288,192)):
  full          the kernel as it is;
  no_ln         the channel-major tile not normalised;
  no_gemm       the products left out;
  no_fg_res     fg and res never loaded (the epilogue reads stale tiles);
  no_store      the output never written out.
esm_flash_attention (bf16, ESM2-3B (4,40,306,64) with 29-45 padded keys,
and _pll at the masked-PLL batch (32,40,122,64); csrc/esm_flash_sm90.cu):
  full          the kernel as it is;
  no_norm       the one-block path's normalisation of P (L <= 128) left
                out;
  no_exp        no exponent (P = the scaled difference itself);
  no_qk         no Q K^T products (S set from constants);
  no_pv         no P V products (P still packed);
  no_kbias      the key-bias rows never built (stale rows);
  no_store      the output never written out;
  l2_none       the tensor maps without L2 promotion (256-byte).
ipa_pair_attend (attn (4,12,288,288) f32, pair (4,288,288,128)):
  full          the kernel as it is;
  no_pair       no pair chunks loaded (stale B fragments);
  no_attn       no attention rows loaded (stale A fragments);
  no_mma        no products (the B fragments still loaded by ldmatrix);
  no_store      the staged rows never written out.
Needs a CUDA device and nvcc; writes the times as JSON to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from abx_tpu_torch.ops import _lib
from abx_tpu_torch.ops import esm_attention as esm_op
from abx_tpu_torch.ops import ipa_attend as ia_op
from abx_tpu_torch.ops import recycle_embed as re_op
from abx_tpu_torch.ops import tri_mult as tm_op
from abx_tpu_torch.tools.ablate_transition import build, time_ms

_NO_SHUFFLE = (
    '  for (int o = 1; o < kLanesPerRow; o <<= 1) {',
    '  for (int o = kLanesPerRow; o < kLanesPerRow; o <<= 1) {')
RECYCLE = {
    'full': [],
    'no_prefetch': [(
        '    if (next < n_grp) load_row(nxt, p, next * kRowsPerGroup + row, '
        'j);\n', '    (void)nxt;\n'), (
        '    cur = nxt;\n',
        '    if (next < n_grp) load_row(cur, p, next * kRowsPerGroup + row, '
        'j);\n')],
    'no_ln': [_NO_SHUFFLE, (
        '  const float mu = s / p.C;\n'
        '  const float rstd = rsqrtf(fmaxf(s2 / p.C - mu * mu, 0.f) + '
        '1e-5f);\n', '  const float mu = 0.f, rstd = 1.f;\n')],
    'no_table': [(
        '  const bool bin_ok = in.bin >= 0 && in.bin < p.n_bins;',
        '  const bool bin_ok = false;')],
    'no_store': [('      store8(out + c, o);',
                  '      if (o[0] == 12345.f) store8(out + c, o);')],
}
_NO_GATE_GEMM = [
    ('        float o[32], gt[32];', '        float o[32], gt[32] = {};'),
    ('            wgmma_ss64(gt, desc_sw128(a_r + a * kAtom + 32 * kk),\n'
     '                       desc_sw128(wgj + a * P::kWAtom + 32 * kk), a + '
     'kk > 0);\n', '            ;\n')]
GATEFOLD = {
    'full': [],
    'no_gate_gemm': _NO_GATE_GEMM,
    'no_gemm': [
        ('        float o[32], gt[32];',
         '        float o[32] = {}, gt[32] = {};'),
        _NO_GATE_GEMM[1],
        ('            wgmma_ss64(o, desc_sw128(a_y + a * kAtom + 32 * kk),\n'
         '                       desc_sw128(wj + a * P::kWAtom + 32 * kk), '
         'a + kk > 0);\n', '            ;\n')],
    'no_ln': [(
        '      ln_in_place<KY>(tile_p, p.NC, s_ysc, s_yb, wi, lane);\n'
        '      ln_in_place<KR>(res_p, p.C, s_xsc, s_xb, wi, lane);\n', '')],
    'no_store': [('          if (m < p.M && c < p.C)\n',
                  '          if (m < 0)\n')],
}
POST_C_MAJOR = {
    'full': [],
    'no_ln': [(
        '      ln_cmajor<KY>(y_p, p.NC, s_sc, s_bi, part, 1 + wg, wi, lane);\n',
        '')],
    'no_gemm': [
        ('        float o[32];\n', '        float o[32] = {};\n'),
        ('            wgmma_ta64(o, desc_mn_sw128(a_y + (64 * a + 16 * kk) * '
         '128),\n                       desc_sw128(wj + a * P::kWAtom + 32 * '
         'kk), a + kk > 0);\n', '            ;\n')],
    'no_fg_res': [(
        '        mbar_expect_tx(fr_full(pw), P::kFR);\n'
        '        for (int a = 0; a < KR; ++a)\n'
        '          tma_load_2d(dst + P::kY + a * kAtom, &map_fg, fr_full(pw), '
        '64 * a,\n                      m0);\n'
        '        for (int a = 0; a < KR; ++a)\n'
        '          tma_load_2d(dst + P::kY + (KR + a) * kAtom, &map_res, '
        'fr_full(pw),\n                      64 * a, m0);\n',
        '        mbar_arrive(fr_full(pw));\n')],
    'no_store': [('          if (r < valid && c < p.C)\n',
                  '          if (r < 0)\n')],
}
IPA_ATTEND = {
    'full': [],
    'no_pair': [(
        '        mbar_expect_tx(bar, pl.stage);\n'
        '        for (int a = 0; a * 64 < C; ++a)\n'
        '          tma_load_3d(base + stage * pl.stage + a * kPC * 128, '
        '&map_pair, bar,\n'
        '                      64 * a, j0, b * L + i0 + r);\n',
        '        mbar_arrive(bar);\n')],
    'no_attn': [(
        '      if (j0 == 0) {  // the row\'s H attention rows, zero past L\n',
        '      if (false) {\n')],
    'no_mma': [(
        '          mma_bf16(acc[u][0], af, rr[0], rr[1]);\n'
        '          if (tp + 1 < ctiles) mma_bf16(acc[u][1], af, rr[2], '
        'rr[3]);\n',
        '          acc[u][0][0] += __uint_as_float((rr[0] ^ rr[1] ^ rr[2] ^ '
        'rr[3] ^ af[0]) & 0x3f000000u);\n')],
    'no_store': [('      *reinterpret_cast<uint4*>(dst + h * C + c) =\n',
                  '      if (h < 0) *reinterpret_cast<uint4*>(dst + h * C + '
                  'c) =\n')],
}
ESM_FLASH = {
    'full': [],
    'no_norm': [('          sc[4 * n + 2 * r] *= inv;\n'
                 '          sc[4 * n + 2 * r + 1] *= inv;\n', '')],
    'no_exp': [('sc[i] = exp2f((sc[i] - m_run[(i >> 1) & 1]) * kLog2e);',
                'sc[i] = (sc[i] - m_run[(i >> 1) & 1]) * kLog2e;')],
    'no_qk': [('        wgmma_128(sc, desc_sw128(q_wg + a * kAtom + 32 * kk),\n'
               '                  desc_sw128(k_s + a * kAtom + 32 * kk), '
               'a + kk > 0);\n',
               '        for (int e = 0; e < 64; ++e) sc[e] = 1e-3f * e;\n')],
    'no_pv': [('        wgmma_rs_tv(o[a], pf[kk],\n'
               '                    desc_mn_sw128(v_s + a * kAtom + kk * 16 '
               '* 128));\n',
               '        o[a][kk] += __uint_as_float((pf[kk][0] ^ pf[kk][1] ^ '
               'pf[kk][2] ^ pf[kk][3]) & 0x3f000000u);\n')],
    'no_kbias': [('    for (int j = tid - 32; j < lp; j += kThreads - 32) {',
                  '    for (int j = tid - 32; j < 0; j += kThreads - 32) {')],
    'no_store': [('      if (l0 + r < L && c < p.D)',
                  '      if (l0 + r < 0 && c < p.D)')],
    'l2_none': [('CU_TENSOR_MAP_L2_PROMOTION_L2_256B',
                 'CU_TENSOR_MAP_L2_PROMOTION_NONE')],
}
KERNELS = {'recycle_embed': ('recycle_embed.cu', 'abx_recycle_embed',
                             RECYCLE),
           'tri_mult_post_gatefold': ('gatefold_sm90.cu',
                                      'abx_tri_mult_post_gatefold_sm90',
                                      GATEFOLD),
           'tri_mult_post_c_major': ('post_cmajor_sm90.cu',
                                     'abx_tri_mult_post_c_major_sm90',
                                     POST_C_MAJOR),
           'ipa_pair_attend': ('ipa_attend.cu', 'abx_ipa_pair_attend',
                               IPA_ATTEND),
           'esm_flash_attention': ('esm_flash_sm90.cu',
                                   'abx_esm_flash_attention', ESM_FLASH),
           'esm_flash_attention_pll': ('esm_flash_sm90.cu',
                                       'abx_esm_flash_attention', ESM_FLASH)}


def _cases(dev):
    """{kernel: (call(fn), want, out)} at the flagship shape, bf16."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    b, l, c, c0, nc = 4, 288, 192, 128, 128
    m = b * l * l
    static, prev = rnd(b, l, l, c0).bfloat16(), rnd(b, l, l, c).bfloat16()
    t_emb = rnd(b, 32).bfloat16()
    rec = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1), rnd(15, c),
           torch.randint(0, 15, (b, l, l), generator=g, device=dev))
    pk = re_op.pack_recycle(*rec[:3])
    rec_out = torch.empty_like(prev)

    def rec_call(fn):
        return fn(1, static.data_ptr(), t_emb.data_ptr(), 0, 32,
                  prev.data_ptr(), pk.ln_scale.data_ptr(),
                  pk.ln_bias.data_ptr(), pk.table.data_ptr(),
                  rec[3].data_ptr(), rec_out.data_ptr(), m, c0, c, l * l, 15,
                  _lib.stream(prev))
    rec_want = re_op.recycle_embed_plain(static, t_emb, prev, *rec)
    y, res = rnd(b, l, l, nc).bfloat16(), rnd(b, l, l, c).bfloat16()
    post = (1 + rnd(nc, scale=0.1), rnd(nc, scale=0.1),
            rnd(c, nc, scale=nc ** -0.5), rnd(c, scale=0.1),
            1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
            rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.5))
    fk = tm_op.pack_gatefold(*post, torch.bfloat16)
    fold_out = torch.empty_like(res)

    def fold_call(fn):
        return fn(y.data_ptr(), res.data_ptr(), m, nc, c, fk.scale.data_ptr(),
                  fk.bias.data_ptr(), fk.w.data_ptr(), fk.wb.data_ptr(),
                  fk.x_scale.data_ptr(), fk.x_bias.data_ptr(),
                  fk.wg.data_ptr(), fk.wgb.data_ptr(), fold_out.data_ptr(),
                  _lib.stream(y))
    fold_want = tm_op.tri_mult_post_gatefold_plain(y, *post, res)
    ycm, fg = rnd(b, nc, l, l).bfloat16(), rnd(b, l, l, c).bfloat16()
    pk = tm_op.pack_post(*post[:4], torch.bfloat16)
    cm_out = torch.empty_like(res)

    def cm_call(fn):
        return fn(ycm.data_ptr(), b, nc, l * l, c, pk.scale.data_ptr(),
                  pk.bias.data_ptr(), pk.w.data_ptr(), pk.wb.data_ptr(),
                  fg.data_ptr(), res.data_ptr(), cm_out.data_ptr(),
                  _lib.stream(ycm))
    cm_want = tm_op.tri_mult_post_plain(ycm, *post[:4], fg, res,
                                        y_c_major=True)
    h, cp = 12, 128
    attn = torch.softmax(rnd(b, h, l, l, scale=2.0), dim=-1)
    pair = rnd(b, l, l, cp).bfloat16()
    ia_out = torch.empty((b, l, h * cp), dtype=torch.bfloat16, device=dev)

    def ia_call(fn):
        return fn(1, attn.data_ptr(), pair.data_ptr(), ia_out.data_ptr(), b,
                  h, l, cp, _lib.stream(pair))
    ia_want = ia_op.ipa_pair_attend_plain(attn, pair)
    flash = {}
    for name, eb, el, padded in (('esm_flash_attention', 4, 306, True),
                                 ('esm_flash_attention_pll', 32, 122, False)):
        q, k, v = ((rnd(eb, el, 40, 64) * (0.125 if i == 0 else 1.0))
                   .bfloat16().transpose(1, 2) for i in range(3))
        epad = torch.zeros(eb, el, dtype=torch.bool, device=dev)
        if padded:
            epad[:, -29:] = True
            epad[2, -45:] = True
        eout = torch.empty((eb, el, 40, 64), dtype=torch.bfloat16,
                           device=dev)
        st = (ctypes.c_longlong * 12)(*(
            s for x in (q, k, v, eout.transpose(1, 2))
            for s in (x.stride(0), x.stride(2), x.stride(1))))

        def flash_call(fn, q=q, k=k, v=v, epad=epad, eout=eout, st=st,
                       eb=eb, el=el):
            return fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      epad.data_ptr(), eout.data_ptr(), ctypes.addressof(st),
                      eb, el, 40, 64, _lib.stream(q))
        flash[name] = (flash_call,
                       esm_op.esm_flash_attention_plain(q, k, v, epad)
                       .transpose(1, 2), eout)
    return {**flash, 'recycle_embed': (rec_call, rec_want, rec_out),
            'tri_mult_post_gatefold': (fold_call, fold_want, fold_out),
            'tri_mult_post_c_major': (cm_call, cm_want, cm_out),
            'ipa_pair_attend': (ia_call, ia_want, ia_out)}


def device_ms(fn, n=20):
    """Device time of one fn() call: the kernels' time under torch.profiler
    over n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='build/ablate_kernels.json')
    ap.add_argument('--kernels', nargs='+', choices=list(KERNELS),
                    default=list(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ablate_kernels needs a CUDA device')
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {'card': card}
    cases = _cases(dev)
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in args.kernels:
            src, entry, variants = KERNELS[kernel]
            work = Path(tmp) / kernel
            work.mkdir()
            libs = build(work, _lib.CSRC / src, variants)
            fns = {}
            for name, (lib, report) in libs.items():
                print(f'{kernel} {name}: ' + '; '.join(report), flush=True)
                fn = getattr(ctypes.CDLL(str(lib)), entry)
                fn.argtypes = _lib._SIGNATURES[entry]
                fn.restype = ctypes.c_int
                fns[name] = fn
            call, want, out = cases[kernel]

            def run(fn):
                err = call(fn)
                if err:
                    raise RuntimeError(f'{kernel}: launch failed, '
                                       f'cudaError_t {err}')
            run(fns['full'])
            torch.cuda.synchronize()
            err = ((out.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            print(f'{kernel} full vs the bf16 plain version: err/max|ref| '
                  f'{err:.3g}', flush=True)
            if not err <= 3e-2:
                raise SystemExit(f'{kernel}: the full variant disagrees '
                                 'with the plain version')
            times = {name: [] for name in fns}
            dev_times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    times[name].append(time_ms(lambda: run(fns[name])))
                    dev_times[name].append(device_ms(lambda: run(fns[name])))
            for name, ts in times.items():
                print(f'{kernel} {name}: '
                      f'{" / ".join(f"{t:.4f}" for t in ts)} ms, device '
                      f'{" / ".join(f"{t:.4f}" for t in dev_times[name])} '
                      f'ms on {card}', flush=True)
            result[kernel] = {'ms': times, 'device_ms': dev_times,
                              'full_rel_err': err,
                              'ptxas': {k: v[1] for k, v in libs.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
