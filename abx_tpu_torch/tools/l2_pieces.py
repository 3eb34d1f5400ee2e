"""How fast the SMs take in operand data from L2, by contiguous piece size.

    python -m abx_tpu_torch.tools.l2_pieces [--out build/l2_pieces.json]

Builds `tools/l2_pieces.cu` with nvcc (sm_90a) and times, with CUDA
events, 1600 blocks that each copy 18 steps of 48 KB from a (4, 288, 288,
128) bf16 tensor in pieces of W = 16 .. 256 contiguous bytes of a cell (the
cells are 256 bytes apart), through a 3-stage cp.async ring.  The
triangle_multiply kernel (`csrc/triangle.cu`) reads pieces of 2C bytes
for the C channels a block holds; this is the measurement that chose
C = 32.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from abx_tpu_torch.ops import _lib

HERE = os.path.dirname(os.path.abspath(__file__))
L, STEPS, BLOCKS, STEP_BYTES = 288, 18, 1600, 48 * 1024


def _build() -> ctypes.CDLL:
    out_dir = _lib.BUILD_ROOT / 'l2_pieces'
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / 'libl2_pieces.so'
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, '-I', str(_lib.CSRC),
                    '-shared', '-o', str(lib),
                    os.path.join(HERE, 'l2_pieces.cu')], check=True,
                   capture_output=True)
    handle = ctypes.CDLL(str(lib))
    handle.abx_l2_pieces.argtypes = [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    handle.abx_l2_pieces.restype = ctypes.c_int
    return handle


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(_lib.BUILD_ROOT.parent /
                                        'l2_pieces.json'))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('l2_pieces: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    handle = _build()
    x = torch.zeros(4 * L * L * 256, dtype=torch.uint8, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def run(w):
        err = handle.abx_l2_pieces(w, x.data_ptr(), L, STEPS, BLOCKS, stream)
        if err:
            raise RuntimeError(f'l2_pieces: launch failed ({err})')

    result = {'card': card, 'blocks': BLOCKS, 'steps': STEPS,
              'step_bytes': STEP_BYTES, 'by_piece_bytes': {}}
    for w in (16, 32, 64, 128, 256):
        for _ in range(3):
            run(w)
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(w)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        tbs = BLOCKS * STEPS * STEP_BYTES / (ms * 1e-3) / 1e12
        result['by_piece_bytes'][w] = {'ms': ms, 'TB_per_s': tbs}
        print(f'pieces of {w:3d} B: {ms:.4f} ms, {tbs:.2f} TB/s into the '
              f'SMs ({card})', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
