"""The program's `abx.` spans in a cell's traced stretch, on the card.

    python3 -m benchmark.tools.span_table --workload <cell> \
        --seed <n> [--seed <n> ...] [--out FILE]

For each seed, one run of the cell as `python3 -m benchmark.run --trace 1`
makes it (set-up, warm-up, the window with the profiled stretch, the
correctness check), the window ended once the stretch (steps
`trace_from` to `trace_from + trace_steps` of the traffic) has closed.
Prints a JSON line a run: `correct`, the per-layer metrics of
`BENCHMARK.json` as that run reads them, the device's busy and wall
seconds over the stretch, the host ms of each traced step (its
`bench.step` range), the numbers `benchmark/spans.py` gives, its longest
gaps and top device operations by span, and its per-span table; the
table also goes to standard error.  On a checkout whose program opens no
`abx.` span the span parts are empty, so the same command on two
checkouts, in turns, compares the cost of the spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def traced_run(cell, seed: int, device: str = 'cuda') -> dict:
    """One run of `cell` ended after its traced stretch: its row."""
    import torch
    from benchmark import cell as cell_lib
    from benchmark import spans as spans_lib
    from benchmark import trace as trace_lib
    stop = int(cell.traffic['trace_from']) + int(cell.traffic['trace_steps'])
    kept = {}
    reduce = trace_lib.reduce

    def reduce_and_keep(prof, spans, steps, window_s):
        evs = list(trace_lib._events(prof))
        kept['spans'] = spans_lib.reduce_events(evs)
        kept['step_host_ms'] = [e.duration_ns() * 1e-6 for e in evs
                                if e.name() == trace_lib.STEP_SPAN
                                and not trace_lib._is_device(e)]
        return reduce(prof, spans, steps, window_s)
    trace_lib.reduce = reduce_and_keep
    try:
        result = cell_lib.run(cell, seed, math.inf, True, device,
                              max_steps=stop)
    finally:
        trace_lib.reduce = reduce
    data = kept.get('spans', spans_lib.ProgramSpans())
    return {
        'workload': cell.name, 'seed': seed,
        'card': (torch.cuda.get_device_name(0) if device == 'cuda'
                 else device),
        'correct': result['correct'],
        'metrics': {k: v['value'] for k, v in result['metrics'].items()},
        'busy_s': result['device'].get('busy_s'),
        'window_s': result['device'].get('window_s'),
        'step_host_ms': kept.get('step_host_ms'),
        'numbers': spans_lib.numbers(data),
        'spans': {k: dataclasses.asdict(v) for k, v in data.spans.items()},
        'sampler_idle_ms': data.sampler_idle_ms,
        'idle_gaps': data.idle_gaps,
        'device_ops': data.device_ops,
        'table': spans_lib.table(data),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, action='append', required=True)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    os.chdir(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import run as run_lib
    run_lib._cache_dirs()
    import torch
    from benchmark import manifest
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 2
    cell = manifest.find_cell(args.workload)
    rows = []
    for seed in args.seed:
        row = traced_run(cell, seed)
        print(f'{args.workload} seed {seed}:', file=sys.stderr)
        for line in row['table']:
            print('  ' + line, file=sys.stderr)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w', encoding='utf-8') as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
