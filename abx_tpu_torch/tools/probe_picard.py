"""Picard sampling at the flagship shape: sweeps to the fixpoint, seconds a
sweep, peak memory.

Counterpart of `tools/probe_picard.py`.  Picard's parallel-in-time sweep
(`sampling/picard.py`) pays off only if it reaches the fixpoint in far
fewer sweeps than the grid has positions.  This measures the sweeps on the
card at the flagship shape (L = 288, B = 1, bf16, ESM off) for num_t in
{25, 100}, at tol 0 (the bitwise fixpoint) and tol 1e-4, each run twice
(cold: the first call at that grid; warm: the second), the first 8
sweep-to-sweep deltas and the peak memory allocated; beside it the
sequential sampler's wall time, and at tol 0 whether the fixpoint equals
the sequential run under the same injected noise.  Writes
`<out>/result.json` (default runs/picard_probe_torch/).

    python -m abx_tpu_torch.tools.probe_picard [--num_t 25 100]
    python -m abx_tpu_torch.tools.probe_picard --tiny --device cpu \\
        --num_t 1 --out /tmp/picard

`--device` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from abx_tpu_torch.tools.overfit_6ct7 import (MODEL_CONFIG, REPO, card_line,
                                              complex_features)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def timed(device, fn):
    """fn's result and its wall seconds, the device synchronised."""
    sync(device)
    t0 = time.time()
    out = fn()
    sync(device)
    return out, time.time() - t0


def gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def probe(sampler, feats, device, tol, noise):
    """Picard at one tolerance: a cold then a warm run."""
    from abx_tpu_torch.sampling.picard import picard_sample

    def run():
        return picard_sample(sampler, feats, gen(device, 3), noise=noise,
                             tol=tol)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    res, cold = timed(device, run)
    res, warm = timed(device, run)
    sweeps = res['picard']['sweeps']
    entry = {
        'sweeps': sweeps,
        'grid_len': len(sampler.step_grids()[0]),
        'wall_s': warm,
        'wall_cold_s': cold,
        'per_sweep_s': warm / max(sweeps, 1),
        'deltas_first8': res['picard']['deltas'][:8],
        'peak_memory_gb': (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == 'cuda' else None),
    }
    return res, entry


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--num_t', type=int, nargs='*', default=[25, 100])
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--no_bf16', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--out', type=str,
                   default=os.path.join(REPO, 'runs', 'picard_probe_torch'))
    args = p.parse_args(argv)

    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.picard import draw_noise
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    rt = runner.build_runtime(None if args.tiny else MODEL_CONFIG,
                              tiny=args.tiny, seed=0, bf16=not args.no_bf16,
                              device=args.device)
    dev = rt.device
    feats = to_device_batch(ds.stack_batch(
        [complex_features(rt)] * args.batch), dev)
    results = {'card': card_line(dev),
               'shape': {'batch': args.batch, 'L': int(feats['seq'].shape[1]),
                         'bf16': not args.no_bf16, 'esm': False},
               'configs': {}}
    for num_t in args.num_t:
        sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                          SamplerConfig(num_t=num_t, mode='design',
                                        generate_area='H3'))
        # The sequential sampler, which Picard competes with.
        entry = {}
        _, entry['sequential_cold_s'] = timed(
            dev, lambda: sampler.sample(feats, gen(dev, 0)))
        _, entry['sequential_wall_s'] = timed(
            dev, lambda: sampler.sample(feats, gen(dev, 1)))
        # Shared noise, so that the fixpoint is the sequential result.
        n = len(sampler.step_grids()[0])
        b, l = feats['seq'].shape
        noise = draw_noise(gen(dev, 2), n, b, l,
                           rt.diffuser.seq.num_states, device=dev)
        for tol_name, tol in (('tol0', 0.0), ('tol1e-4', 1e-4)):
            try:
                res, entry[tol_name] = probe(sampler, feats, dev, tol, noise)
            except torch.cuda.OutOfMemoryError as e:
                entry[tol_name] = {'error': f'{type(e).__name__}: {e}'[:300]}
                torch.cuda.empty_cache()
                continue
            if tol == 0.0:
                same = sampler.sample(feats, gen(dev, 3), noise=noise)
                entry[tol_name]['seq_matches_sequential'] = bool(
                    torch.equal(res['seq'], same['seq']))
                entry[tol_name]['atom14_max_dev_A'] = float(
                    (res['atom14'].float() - same['atom14'].float()
                     ).abs().max())
            del res
        results['configs'][f't{num_t}'] = entry
        print(json.dumps({f't{num_t}': entry}), flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'result.json'), 'w',
              encoding='utf-8') as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == '__main__':
    main()
