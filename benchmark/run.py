"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Loads the cell's configuration and traffic (`BENCHMARK.json`),
builds the program and its weights, warms up, measures for `--seconds`,
checks the timed path's outputs against the plain reference, and prints
one JSON line last on standard output: the end-to-end metrics with
`--trace 0`, the per-layer metrics (from a profiled stretch of the
window) with `--trace 1`.  The numbers compared and their limits are the
last lines on standard error.  Exits non-zero, printing no result, when
the card is missing, or when `jax`, `jaxlib`, `flax` or `abx_tpu` is
loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Every cache the program or a library writes lives at a fixed path
    inside the checkout, so that only a checkout's first run builds: the
    port's kernels (`build/abx_tpu_torch/<source hash>`, fixed by the
    port) and IGSO(3) tables (`.cache/`, from the configuration), and
    Triton's and PyTorch's extension caches, set here."""
    os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, '.cache', 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                      'torch_extensions')


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    _cache_dirs()
    from benchmark import cell as cell_lib
    from benchmark import manifest
    cell = manifest.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); '
              f'available: {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace),
                          'cuda', T_PROCESS)
    banned = cell_lib.banned_modules()
    if banned:
        print(f'loaded after the window: {banned} (the benchmark runs the '
              'PyTorch port alone)', file=sys.stderr)
        return 3
    print(f'correct: {result["correct"]}', file=sys.stderr)
    for name, row in result['checked'].items():
        print(f'check {name}: {row["value"]!r} limit {row["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
