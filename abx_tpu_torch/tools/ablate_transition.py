"""What sets the pace of the Hopper transition kernel, by cutting parts out.

    python -m abx_tpu_torch.tools.ablate_transition \
        [--out build/ablate_transition.json]

Builds variants of `csrc/transition_sm90.cu`, each with one part of the
work removed by a source edit, into libraries of their own (one nvcc each,
all started together; the `-Xptxas -v` report of each is printed), and
times each at the flagship shape (x (4, 288, 288, 192) bf16, N = 768; median
of CUDA-event timings after warm-up) in turns, twice.  The variants compute
wrong values on purpose; only `full` is checked against the plain version.
  full          the kernel as it is;
  no_wstream    the weights loaded for the first two chunks of a block only
                (the ring's barriers still run): no L2 weight traffic;
  no_gemm1      GEMM1's wgmma left out (h from the bias alone);
  no_gemm2      GEMM2's wgmma left out;
  no_gemm       both;
  no_bias_relu  h = acc, rounded (no b1 loads, no ReLU);
  no_epilogue   Y never staged, rounded or stored.
Needs a CUDA device and nvcc; writes the times as JSON to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from abx_tpu_torch.ops import _lib, transition as tr_op

SRC = _lib.CSRC / 'transition_sm90.cu'

# (variant, [(text in the source, its replacement)]): every text must occur.
VARIANTS = {
    'full': [],
    'no_wstream': [(
        '        if (u >= kStages) mbar_wait(w_empty + 8 * s, ((u / kStages) '
        '+ 1) & 1);\n',
        '        if (u >= kStages) mbar_wait(w_empty + 8 * s, ((u / kStages) '
        '+ 1) & 1);\n'
        '        if (u >= kStages) { mbar_arrive(w_full + 8 * s); ++u; '
        'return; }\n')],
    'no_gemm1': [('float acc[32];', 'float acc[32] = {};'), (
        '            wgmma_ss64(acc, desc_sw128(a_base + a * kBM * 128 + 32 * '
        'kk),\n'
        '                       desc_sw128(w1s + a * kNB * 128 + 32 * kk), a '
        '+ kk > 0);\n',
        '            ;\n')],
    'no_gemm2': [('float y[32 * KA];', 'float y[32 * KA] = {};'), (
        '          wgmma_rs(y, hf[kk], desc_sw128(w2s + 32 * kk), jc + kk > '
        '0);\n',
        '          y[kk] += __uint_as_float(hf[kk][0] ^ hf[kk][3]);\n')],
    'no_gemm': [],   # no_gemm1's and no_gemm2's edits together
    'no_bias_relu': [(
        '              const float bv = n < p.N ? p.b1[n] : 0.f;\n',
        '              const float bv = 0.f;\n'), (
        '                    fmaxf(acc[8 * kk + 4 * q + 2 * h + x] + bv, '
        '0.f);\n',
        '                    acc[8 * kk + 4 * q + 2 * h + x] + bv;\n')],
    'no_epilogue': [(
        '            *reinterpret_cast<uint4*>(p.out + o) = sm90::pack8(v);\n',
        '            if (v[0] == 12345.f) *reinterpret_cast<uint4*>(p.out + '
        'o) = sm90::pack8(v);\n'), (
        '            *reinterpret_cast<float2*>(wst + r * 64 + (col ^ (8 * (r '
        '& 7)))) =\n'
        '                make_float2(y[4 * nt + 2 * h] + b0, y[4 * nt + 2 * h '
        '+ 1] + b1v);\n',
        '            if (y[4 * nt + 2 * h] == 12345.f)\n'
        '              *reinterpret_cast<float2*>(wst) = make_float2(b0, '
        'b1v);\n')],
}
VARIANTS['no_gemm'] = VARIANTS['no_gemm1'] + VARIANTS['no_gemm2']


def build(work: Path, src=SRC, variants=None):
    """{variant: (library, ptxas report)} of `src` with each of `variants`'
    edits (VARIANTS by default), one nvcc a variant, together."""
    text = src.read_text()
    nvcc = _lib._nvcc()
    procs = {}
    for name, edits in (variants or VARIANTS).items():
        code = text
        for old, new in edits:
            if code.count(old) != 1:
                raise RuntimeError(f'{name}: the source no longer holds '
                                   f'{old!r}')
            code = code.replace(old, new)
        cu = work / f'{name}.cu'
        cu.write_text(code)
        lib = work / f'lib{name}.so'
        cmd = [nvcc, *_lib.NVCC_FLAGS, '-I', str(_lib.CSRC), '-shared', '-o',
               str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log[-4000:]}')
        report = []
        for ln in log.splitlines():
            ln = ln.strip()
            if (('registers' in ln or 'spill' in ln or 'Performance' in ln)
                    and ln not in report):
                report.append(ln)
        out[name] = (lib, report)
    return out


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default='build/ablate_transition.json')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ablate_transition needs a CUDA device')
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        fns = {}
        for name, (lib, report) in libs.items():
            print(f'{name}: ' + '; '.join(report), flush=True)
            fn = ctypes.CDLL(str(lib)).abx_fused_transition_sm90
            fn.argtypes = _lib._SIGNATURES['abx_fused_transition_sm90']
            fn.restype = ctypes.c_int
            fns[name] = fn
        g = torch.Generator(device=dev).manual_seed(0)
        b, l, c, n = 4, 288, 192, 768
        x = torch.randn(b, l, l, c, generator=g, device=dev).bfloat16()
        params = (1 + 0.1 * torch.randn(c, generator=g, device=dev),
                  0.1 * torch.randn(c, generator=g, device=dev),
                  torch.randn(n, c, generator=g, device=dev) * c ** -0.5,
                  0.1 * torch.randn(n, generator=g, device=dev),
                  torch.randn(c, n, generator=g, device=dev) * n ** -0.5,
                  0.1 * torch.randn(c, generator=g, device=dev))
        pk = tr_op.pack_transition(*params, torch.bfloat16)
        out = torch.empty_like(x)

        def call(fn):
            err = fn(x.data_ptr(), b * l * l, c, pk.scale.data_ptr(),
                     pk.bias.data_ptr(), pk.w1.data_ptr(), pk.b1.data_ptr(),
                     pk.w2.data_ptr(), pk.b2.data_ptr(), out.data_ptr(), n,
                     _lib.stream(x))
            if err:
                raise RuntimeError(f'launch failed: cudaError_t {err}')
        call(fns['full'])
        want = tr_op.fused_transition_plain(x.float(), *params)
        torch.cuda.synchronize()
        err = ((out.float() - want).abs().max() / want.abs().max()).item()
        print(f'full vs the f32 plain version: err/max|ref| {err:.3g}',
              flush=True)
        if not err <= 3e-2:
            raise SystemExit('the full variant disagrees with the plain '
                             'version')
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(time_ms(lambda: call(fns[name])))
        for name, ts in times.items():
            print(f'{name}: {" / ".join(f"{t:.4f}" for t in ts)} ms on '
                  f'{card}', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump({'card': card, 'ms': times, 'full_rel_err': err,
                   'ptxas': {k: v[1] for k, v in libs.items()}}, f, indent=1)


if __name__ == '__main__':
    main()
