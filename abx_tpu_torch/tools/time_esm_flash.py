"""Time the ESM2 flash route's attention (kernel row 15) on one card, for
the package of the checkout at --root (default: the one holding this
file), so that two commits can be compared in turns within one call:

    python3 abx_tpu_torch/tools/time_esm_flash.py --out build/new.json
    python3 abx_tpu_torch/tools/time_esm_flash.py --root build/parent \\
        --out build/parent.json

Run it as a script (not with -m), so that the package comes from --root.
At the ESM2-3B shape (4, 40, 306, 64; 29-45 padded keys, as chip_smoke.py
phase 3) and the masked-PLL batch (32, 40, 122, 64; no padded key), on
head-major views of (B, L, H, D) tensors: `esm_flash_attention` in bf16
and f32, `esm_attention` (row 12) in bf16 and SDPA with the segment mask
in bf16, on the same operands.  Per call: the median of --reps CUDA-event
timings of one call after two warm-ups (host work included where it is
the slower), and the device time a call from torch.profiler (the summed
device kernels of --prof_calls calls over the calls) with the kernels'
names, and the host time a call (--host_calls calls enqueued back to
back, the host clock over the loop: the wrapper's own cost).  Prints one
line a row and writes JSON to --out.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _time_ms(torch, fn, reps):
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


def _device_ms(torch, fn, calls):
    """(device ms a call, distinct kernel names) over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, []
    return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / calls,
            sorted({e.name[:100] for e in ev}))


def _host_us(torch, fn, calls):
    """Host microseconds a call: `calls` calls enqueued back to back (the
    card's queue absorbs them), the host clock over the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--root', default=HERE_ROOT,
                   help='checkout whose abx_tpu_torch is timed')
    p.add_argument('--out', required=True)
    p.add_argument('--reps', type=int, default=21)
    p.add_argument('--prof_calls', type=int, default=20)
    p.add_argument('--host_calls', type=int, default=200)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from abx_tpu_torch.ops import esm_attention as esm_op
    if not torch.cuda.is_available():
        raise SystemExit('time_esm_flash: needs a CUDA device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    h, d = 40, 64
    result = {'card': card, 'root': root,
              'package': os.path.dirname(esm_op.__file__), 'rows': []}
    if hasattr(esm_op, 'flash_kernel_info'):
        result['flash_kernel_info'] = {
            str(l): esm_op.flash_kernel_info(d, l) for l in (306, 122)}
        print(f'flash kernel info (D = 64): '
              f'{json.dumps(result["flash_kernel_info"])}', flush=True)
    for label, b, l, padded in (('ESM2-3B', 4, 306, True),
                                ('PLL', 32, 122, False)):
        q, k, v = ((torch.randn(b, l, h, d, generator=g, device=dev)
                    * (d ** -0.5 if i == 0 else 1.0)).transpose(1, 2)
                   for i in range(3))
        pad = torch.zeros(b, l, dtype=torch.bool, device=dev)
        if padded:
            pad[:, -29:] = True
            pad[2, -45:] = True
        seg = pad[:, None, :, None] == pad[:, None, None, :]

        def low(x):
            return x.transpose(1, 2).bfloat16().transpose(1, 2)
        q16, k16, v16 = low(q), low(k), low(v)
        fns = {
            'esm_flash_attention bf16':
                lambda: esm_op.esm_flash_attention(q16, k16, v16, pad),
            'esm_flash_attention f32':
                lambda: esm_op.esm_flash_attention(q, k, v, pad),
            'esm_attention bf16':
                lambda: esm_op.esm_attention(q16, k16, v16, pad),
            'sdpa segment mask bf16':
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q16, k16, v16, attn_mask=seg, scale=1.0),
        }
        for name, fn in fns.items():
            ms = _time_ms(torch, fn, args.reps)
            dev_ms, names = _device_ms(torch, fn, args.prof_calls)
            host_us = _host_us(torch, fn, args.host_calls)
            row = {'shape': label, 'dims': [b, h, l, d], 'fn': name,
                   'ms': ms, 'device_ms': dev_ms, 'host_us': host_us,
                   'kernels': names}
            result['rows'].append(row)
            dtxt = f'{dev_ms:.4f}' if dev_ms is not None else 'not recorded'
            print(f'{label} ({b},{h},{l},{d}) {name}: {ms:.4f} ms, device '
                  f'{dtxt} ms a call, host {host_us:.1f} us a call, kernels '
                  f'{names} ({card})', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
