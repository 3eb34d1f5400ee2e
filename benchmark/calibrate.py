"""The readings that the correctness limits are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control] [--out FILE]

For each seed, in one process: the cell's program with that seed's
weights runs the window's first steps up to the last checked one (no
timing), then the program is dropped and the reference compares the
checked steps as a run's check does (`cell.run_check`).  With
`--control` it also gives the control's numbers: the reference in
float8 put in the program's place on the same inputs, which must fail.
Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control', action='store_true')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    from benchmark import run as run_mod
    run_mod._cache_dirs()
    import torch
    from benchmark import cell as cell_lib
    from benchmark import manifest
    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, 'a', encoding='utf-8') if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog = cell_lib.Program(cell.config_path, cell.traffic, seed, dev)
        steps = cell_lib.check_steps(seed, cell.traffic)
        cap = cell_lib.warm_up(prog, seed, steps)
        cell_lib.window(prog, cap, seed, float('inf'),
                        max_steps=max(steps) + 1)
        cell_lib.release(prog, cap)
        del prog
        t1 = time.perf_counter()
        numbers, ctrl = cell_lib.run_check(cell.config_path, cell.traffic,
                                           seed, cap, dev,
                                           control=args.control)
        line = json.dumps({'workload': cell.name, 'seed': seed,
                           'steps': steps, 'program': numbers,
                           'control': ctrl,
                           'program_s': t1 - t0,
                           'check_s': time.perf_counter() - t1})
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()
        del cap
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
