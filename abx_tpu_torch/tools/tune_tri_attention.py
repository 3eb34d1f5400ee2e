"""Query-tile height and rows a block of the triangle attention core.

    python -m abx_tpu_torch.tools.tune_tri_attention \
        [--out build/tune_tri_attention.json]

Builds `csrc/tri_attention.cu` once per (QW, RB) with -DABX_TRI_QW=QW
(warps of 16 queries a row group: QB = 16 QW queries a tile) and
-DABX_TRI_RB=RB (the most rows a block, sharing each bias tile), one nvcc
each, started together, and times
each build's entry points with CUDA events (median of 9 after warm-up; the
builds in turns, forward then backward, and the lower of the two medians
kept) at the flagship shapes in bf16: the packed rows' core on ready
projection rows (tri (4, 288, 288) H=4 D=48, gated, bf16 exponent on and
off; seq (4, 1, 288) H=32 D=17), the columns' core, and
triangle_attention_fused (4, 288, 4, 288, 48) with its f32 bias.  Each
output is held to the package's own build (`ops/_lib.py`) on the same
inputs.  This is what chose the defaults in `csrc/tri_attention.cu`.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from abx_tpu_torch.ops import _lib

# (QW, RB): warps of 16 queries a row group, rows a block.
VARIANTS = [(4, 2), (6, 2), (6, 1), (4, 4)]
ENTRIES = ('abx_tri_attention_core', 'abx_triangle_attention_fused')


def _name(v):
    return 'qw{}_rb{}'.format(*v)


def _build():
    """{(qw, rb): CDLL} of the tri_attention.cu builds."""
    out_dir = _lib.BUILD_ROOT / 'tune' / _lib.source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(_lib.CSRC / 'tri_attention.cu')
    libs = {v: out_dir / f'lib{_name(v)}.so' for v in VARIANTS}
    todo = [v for v in VARIANTS if not libs[v].exists()]
    codes = _lib._run_all(
        [[_lib._nvcc(), *_lib.NVCC_FLAGS, f'-DABX_TRI_QW={qw}',
          f'-DABX_TRI_RB={rb}', '-shared', '-o', str(libs[(qw, rb)]), src]
         for qw, rb in todo],
        [out_dir / f'{_name(v)}.log' for v in todo])
    if any(codes):
        raise RuntimeError(f'nvcc failed: {codes}, logs in {out_dir}')
    handles = {}
    for v, path in libs.items():
        handle = ctypes.CDLL(str(path))
        for name in ENTRIES:
            fn = getattr(handle, name)
            fn.argtypes = _lib._SIGNATURES[name]
            fn.restype = ctypes.c_int
        handles[v] = handle
    return handles


def _cases(dev):
    """(label, fn(lib) -> output tensor) at the flagship shapes, bf16."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, l = 4, 288
    mask = torch.ones(b, l, device=dev)
    mask[:, -9:] = 0.0
    cases = []

    def core(label, r, h, d, bf16_exp, columns):
        n = b * r * l
        y = torch.randn(n, 4 * h * d, generator=g, device=dev)
        y[:, :h * d] *= d ** -0.5
        y = y.bfloat16()
        bias = torch.randn(b, h, l, l, generator=g, device=dev).bfloat16()
        out = torch.empty(n, h * d, dtype=torch.bfloat16, device=dev)

        def run(lib):
            _lib.check(lib.abx_tri_attention_core(
                1, y.data_ptr(), 4 * h * d, b, r, l, h, d, bias.data_ptr(),
                mask.data_ptr(), 1, int(bf16_exp), int(columns),
                out.data_ptr(), _lib.stream(y)), label)
            return out
        cases.append((label, run))

    core('rows tri (4,288,288) H=4 D=48, bf16 exp 1', l, 4, 48, True, False)
    core('rows tri (4,288,288) H=4 D=48, bf16 exp 0', l, 4, 48, False,
         False)
    core('rows seq (4,1,288) H=32 D=17, bf16 exp 1', 1, 32, 17, True, False)
    core('columns (4,288,288) H=4 D=48, bf16 exp 1', l, 4, 48, True, True)
    h, d = 4, 48
    q, k, v = (torch.randn(b, l, h, l, d, generator=g, device=dev).bfloat16()
               for _ in range(3))
    bias = torch.randn(b, h, l, l, generator=g, device=dev)
    out = torch.empty_like(q)

    def fused(lib):
        _lib.check(lib.abx_triangle_attention_fused(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, l, h, l, d,
            _lib.stream(q)), 'fused')
        return out
    cases.append(('fused (4,288,4,288,48), f32 bias', fused))
    return cases


def _time_ms(fn, reps=9):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(_lib.BUILD_ROOT.parent /
                                        'tune_tri_attention.json'))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('tune_tri_attention: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    handles = _build()
    package = _lib.lib()
    report = {'card': card, 'cases': {}}
    for label, run in _cases(dev):
        want = run(package).clone()
        times = {v: [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for v in order:
                got = run(handles[v])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if err > 3e-2 * want.float().abs().max().item():
                    raise SystemExit(f'{label}: {_name(v)} differs from '
                                     f'the package by {err}')
                times[v].append(_time_ms(lambda: run(handles[v])))
        row = {_name(v): min(ts) for v, ts in times.items()}
        report['cases'][label] = row
        print(f'{label}: ' + ', '.join(f'{k} {t:.3f} ms'
                                       for k, t in row.items()), flush=True)
    print(card)
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == '__main__':
    main()
