"""The port's benchmark: CDR-H3 design throughput on one GPU.

    python -m abx_tpu_torch.tools.bench [--reps 3] [--num_t 100] \
        [--out build/bench.json]

Counterpart of the JAX package's `bench.py`, on the same workload: the
released model config (`config/config_model.json`, random weights from seed
0, bf16 trunk), B = 4 samples of testdata/6ct7_H_L_S.pdb (L = 256 + 32),
num_t 100 CDR-H3 design.  Configs:

  * `no_esm`             -- the trunk alone;
  * `esm`                -- conditioned on ESM2-3B at full width (random
                            weights made on the card), three ESM passes a
                            step: the reference's configuration and the
                            headline when it ran;
  * `esm_reuse`          -- one ESM pass a step, shared by the recycle
                            passes;
  * `esm_reuse_refresh8` -- the ESM embedding recomputed every 8th step;
  * `fast_recipe_t25`    -- a quarter of the steps (num_t 25 at the
                            default 100), refresh every 8th step and two
                            sequence Gibbs-corrector jumps a step.
The last three change the output (`output_changing_opt_in`) and are never
the headline; a rung that fails is recorded inline.  One runtime with ESM
off and one with ESM on are built once and shared by the configs.

Timing: one warm-up trajectory per config, then `--reps` timed
trajectories per config, interleaved across the configs with their order
rotated each round (the host's order effect is larger than a kernel
change).  A trajectory is timed with `torch.cuda.synchronize()` at its
edges only.  Per config: every rep's seconds per step (trajectory / num_t),
their median, min and spread ((max - min) / median), samples/hour from the
median, batch and wall steps per second, the analytic FLOPs of
`bench.py` over the H100 SXM dense bf16 peak (989 TFLOP/s) as `mfu`, the
peak memory allocated, the kernels' build time and the warm-up's.

The `ABX_*` kernel flags of the environment apply to the whole run (run it
again under other flags to measure another kernel configuration); the
bench does not choose them.  Environment: BENCH_NUM_T, BENCH_BATCH,
BENCH_BF16 (default 1), BENCH_ONLY=esm|no_esm (or --esm / --no-esm:
`esm` runs the ESM config and its rungs), BENCH_SKIP_REUSE=1 (no rungs).
Prints one JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}.  Runs on the card and raises without one; `--device cpu --tiny`
(tiny model and ESM2) exists for the CPU test.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PDB = os.path.join(REPO, 'testdata', '6ct7_H_L_S.pdb')
MODEL_CONFIG = os.path.join(REPO, 'config', 'config_model.json')

# The JAX package's reference anchors (bench.py): AbX in PyTorch on an
# A100, 100-step designs, estimated (no published number exists) without
# and with ESM2-3B in the loop.
A100_REFERENCE_SAMPLES_PER_HR = 257.0
A100_REFERENCE_SAMPLES_PER_HR_ESM = 90.0
# NVIDIA's published dense bf16 tensor-core peak of one H100 SXM at 700 W.
PEAK_TFLOPS = 989.0

# name -> (ESM on, steps per num_t, esm_reuse_recycles, esm_refresh_every,
# seq_corrector_steps); the rungs after `esm` change the output.
CONFIGS = {
    'no_esm': (False, 1, False, 1, 0),
    'esm': (True, 1, False, 1, 0),
    'esm_reuse': (True, 1, True, 1, 0),
    'esm_reuse_refresh8': (True, 1, True, 8, 0),
    'fast_recipe_t25': (True, 0.25, True, 8, 2),
}
RUNGS = ('esm_reuse', 'esm_reuse_refresh8', 'fast_recipe_t25')


def analytic_flops_per_step(esm: bool, batch: int, l: int = 288,
                            l_esm: int = 306, esm_passes: float = 3) -> float:
    """Matmul FLOPs per diffusion step of the released config (a lower
    bound; elementwise work excluded), copied from `bench.py`.  Dims from
    config/config_model.json: seq 544ch, pair 192ch, tri-mult nc=128,
    tri-attn 4x32, seq-attn 32 heads, transitions x4, OPM 64ch, IPA
    8x256ch/12h; ESM2-3B d=2560, 36 layers.  One diffusion step = 3 trunk
    passes (2 recycles + final), each with an ESM pass when conditioning is
    on (`esm_passes` per step with the reuse options)."""
    n, n2, n3 = float(l), float(l)**2, float(l)**3
    cs, cp, nc = 544.0, 192.0, 128.0
    seq = (8 * n * cs**2            # seq-attn q/k/v/gate
           + 2 * n * cs**2          # seq-attn out proj
           + 2 * n2 * cp * 32       # pair-bias projection
           + 4 * n2 * cs            # seq-attn logits+attend
           + 16 * n * cs**2)        # seq transition (x4 factor)
    opm = 4 * n * cs * 64 + 2 * n2 * 64 + 2 * n2 * 128 * cp
    tri_mult = 2 * (5 * 2 * n2 * cp * nc   # pre: left/right/3 gates
                    + 2 * n3 * nc          # triangle contraction
                    + 2 * n2 * nc * cp)    # post proj
    tri_attn = 2 * (3 * 2 * n2 * cp * nc   # packed q/k/v proj
                    + 2 * 2 * n2 * cp * nc  # gate + out proj
                    + 2 * n2 * cp * 4      # bias proj
                    + 4 * n3 * nc)         # logits + attend
    pair_trans = 16 * n2 * cp**2
    ipa = 8 * (2 * n * 256 * (3 * 192 + 576)   # scalar qkv + point qkv
               + 2 * n2 * 192                  # scalar logits
               + 2 * n2 * 12 * cp              # attend over pair
               + 2 * n * 2800 * 256            # concat out proj
               + 8 * n * 256**2)               # transition stack
    heads = 2 * n2 * cp * 64 + 6 * n * 256**2
    trunk_pass = seq + opm + tri_mult + tri_attn + pair_trans + ipa + heads
    per_step = 3 * trunk_pass
    if esm:
        ne, d = float(l_esm), 2560.0
        esm_layer = 24 * ne * d**2 + 4 * ne**2 * d
        per_step += esm_passes * (36 * esm_layer + 2 * ne * 33 * d)
    return per_step * batch


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0].strip() if out.stdout else ''


def build_runtimes(device: str = 'cuda', bf16: bool = True,
                   tiny: bool = False, esm: bool = True,
                   no_esm: bool = True) -> Dict:
    """{'no_esm': Runtime, 'esm': Runtime} (those asked for): the released
    config with random weights from seed 0, ESM2-3B at full width with
    random weights made on the device (with `tiny`: the tiny model and a
    2-layer, 64-wide ESM2)."""
    from abx_tpu_torch.cli import runner
    kw = dict(tiny=tiny, seed=0, bf16=bf16, device=device)
    cfg_path = None if tiny else MODEL_CONFIG
    out = {}
    if no_esm:
        out['no_esm'] = runner.build_runtime(cfg_path, **kw)
    if esm:
        tiny_esm = dict(esm_layers=2, esm_dim=64) if tiny else {}
        out['esm'] = runner.build_runtime(cfg_path, esm_random=True,
                                          **tiny_esm, **kw)
    return out


@dataclasses.dataclass
class Case:
    """One config, ready to run trajectories."""
    name: str
    sampler: object
    feats: Dict[str, torch.Tensor]
    num_t: int
    batch: int
    bf16: bool
    flops: Optional[float]   # per trajectory; None for the tiny model


def make_case(name: str, runtimes: Dict, num_t: int, batch: int,
              tiny: bool = False) -> Case:
    """The sampler and the batched features of config `name`."""
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    esm, share, reuse, refresh, corrector = CONFIGS[name]
    num_t = max(1, int(num_t * share))
    rt = runtimes['esm' if esm else 'no_esm']
    feats, _ = next(runner.load_complexes(None, None, PDB, rt))
    feats = {k: np.repeat(v, batch, axis=0)
             for k, v in ds.stack_batch([feats]).items()}
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=num_t, esm_reuse_recycles=reuse,
                                    esm_refresh_every=refresh,
                                    seq_corrector_steps=corrector),
                      esm_fn=rt.esm)
    flops = None if tiny else analytic_flops_per_step(
        esm, batch, esm_passes=(1.0 / refresh if reuse else 3)) * num_t
    return Case(name, sampler, to_device_batch(feats, rt.device), num_t,
                batch, rt.model.dtype == torch.bfloat16, flops)


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def trajectory_s(case: Case, seed: int) -> float:
    """Seconds of one whole design trajectory, synchronized at its edges
    only."""
    dev = case.feats['seq'].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    case.sampler.sample(case.feats, gen)
    _sync(dev)
    return time.perf_counter() - t0


def measure(cases: List[Case], reps: int) -> Dict[str, Dict]:
    """One warm-up trajectory per case, then `reps` timed ones per case,
    interleaved with the order rotated each round.  A case whose
    trajectory raises is recorded as {'error': ...} and dropped."""
    results: Dict[str, Dict] = {}
    times: Dict[str, List[float]] = {c.name: [] for c in cases}
    peaks: Dict[str, int] = {c.name: 0 for c in cases}
    live = list(cases)

    def run(case, seed):
        dev = case.feats['seq'].device
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            s = trajectory_s(case, seed)
        except Exception as e:  # noqa: BLE001 -- a rung's failure is data
            results[case.name] = {'error': f'{type(e).__name__}: {e}'[:300]}
            live.remove(case)
            return None
        if dev.type == 'cuda':
            peaks[case.name] = max(peaks[case.name],
                                   torch.cuda.max_memory_allocated(dev))
        return s

    warm = {}
    for case in list(live):
        warm[case.name] = run(case, 0)
    for r in range(reps):
        k = r % len(live) if live else 0
        for case in live[k:] + live[:k]:
            s = run(case, r + 1)
            if s is not None:
                times[case.name].append(s)
    for case in cases:
        if case.name in results:
            continue
        ts = times[case.name]
        med = statistics.median(ts)
        per_step = [t / case.num_t for t in ts]
        detail = {
            's_per_step': per_step,
            's_per_step_median': med / case.num_t,
            's_per_step_min': min(per_step),
            's_per_step_spread': (max(ts) - min(ts)) / med,
            'samples_per_hr': case.batch / med * 3600.0,
            'batch_steps_per_sec': case.batch * case.num_t / med,
            'wall_steps_per_sec': case.num_t / med,
            'batch': case.batch,
            'num_t': case.num_t,
            'bf16': case.bf16,
            'reps': len(ts),
            'warmup_s': warm[case.name],
            'mfu': (case.flops / med / (PEAK_TFLOPS * 1e12)
                    if case.flops else None),
            'tflops_per_step': (case.flops / case.num_t / 1e12
                                if case.flops else None),
            'hbm_peak_gb': peaks[case.name] / 2**30 if peaks[case.name]
            else None,
        }
        results[case.name] = detail
    return results


def bench_config(name: str, runtimes: Dict, num_t: int, batch: int = 4,
                 reps: int = 3, tiny: bool = False) -> Dict:
    """One config alone on ready runtimes: its warm-up and `reps` timed
    trajectories (the detail `measure` gives it)."""
    detail = measure([make_case(name, runtimes, num_t, batch, tiny)],
                     reps)[name]
    _annotate(name, detail)
    return detail


def _annotate(name: str, detail: Dict) -> None:
    if 'error' in detail:
        return
    esm = CONFIGS[name][0]
    base = (A100_REFERENCE_SAMPLES_PER_HR_ESM if esm
            else A100_REFERENCE_SAMPLES_PER_HR)
    detail['vs_baseline'] = detail['samples_per_hr'] / base
    if name in RUNGS:
        detail['output_changing_opt_in'] = True


def run(device: str = 'cuda', tiny: bool = False,
        num_t: Optional[int] = None, batch: Optional[int] = None,
        bf16: Optional[bool] = None, reps: int = 3,
        only: str = '') -> Dict:
    """Build the runtimes and measure the configs; the result dict that
    `main` prints."""
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.ops import _lib
    dev = runner.resolve_device(device)
    num_t = num_t or int(os.environ.get('BENCH_NUM_T', 100))
    batch = batch or int(os.environ.get('BENCH_BATCH', 4))
    if bf16 is None:
        bf16 = os.environ.get('BENCH_BF16', '1') == '1'
    only = only or os.environ.get('BENCH_ONLY', '')
    build_s = None
    if dev.type == 'cuda':
        t0 = time.perf_counter()
        _lib.build()
        _lib.lib()
        build_s = time.perf_counter() - t0
    names = [n for n in CONFIGS
             if (only != 'esm' or CONFIGS[n][0])
             and (only != 'no_esm' or n == 'no_esm')
             and not (n in RUNGS
                      and os.environ.get('BENCH_SKIP_REUSE', '0') == '1')]
    runtimes = build_runtimes(
        device, bf16, tiny, esm=any(CONFIGS[n][0] for n in names),
        no_esm='no_esm' in names)
    cases, results = [], {}
    for n in names:
        try:
            cases.append(make_case(n, runtimes, num_t, batch, tiny))
        except Exception as e:  # noqa: BLE001 -- recorded inline
            results[n] = {'error': f'{type(e).__name__}: {e}'[:300]}
    results.update(measure(cases, reps))
    for n in names:
        _annotate(n, results[n])
    results = {n: results[n] for n in names}
    head_key = 'esm' if 'samples_per_hr' in results.get('esm', {}) \
        else 'no_esm'
    head = results[head_key]
    flags = {k: v for k, v in sorted(os.environ.items())
             if k.startswith('ABX_')}
    return {
        'metric': 'design_samples_per_hour_per_chip',
        'value': head.get('samples_per_hr', 0.0),
        'unit': (f'samples/hr ({head.get("num_t", num_t)}-step H3 design, '
                 f'L=288, {"bf16" if bf16 else "f32"} '
                 f'{"ESM2-3B-conditioned" if head_key == "esm" else "no-ESM"}'
                 f' trunk{", tiny model" if tiny else ""})'),
        'vs_baseline': head.get('vs_baseline', 0.0),
        'detail': {
            'device': {
                'name': (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else 'cpu'),
                'card': card_line() if dev.type == 'cuda' else None,
                'count': (torch.cuda.device_count()
                          if dev.type == 'cuda' else 0),
            },
            'torch': torch.__version__,
            'kernel_build_s': build_s,
            'kernel_flags': flags,
            'bf16': bf16,
            'configs': results,
        },
    }


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu' "
                        '(with --tiny: the CPU test)')
    p.add_argument('--tiny', action='store_true',
                   help='tiny model and ESM2 (the CPU test)')
    p.add_argument('--num_t', type=int, default=None,
                   help='diffusion steps (default BENCH_NUM_T or 100)')
    p.add_argument('--reps', type=int, default=3,
                   help='timed trajectories per config')
    p.add_argument('--esm', action='store_true',
                   help='the ESM config and its rungs only')
    p.add_argument('--no-esm', dest='no_esm', action='store_true',
                   help='the no_esm config only')
    p.add_argument('--out', type=str, default=None,
                   help='also write the JSON line to this file')
    args = p.parse_args(argv)
    only = 'esm' if args.esm else ('no_esm' if args.no_esm else '')
    result = run(args.device, args.tiny, args.num_t, reps=args.reps,
                 only=only)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(line + '\n')
    print(line, flush=True)
    return result


if __name__ == '__main__':
    main()
