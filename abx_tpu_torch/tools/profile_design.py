"""Steady-state design speed and where the device time goes, on one card.

    python -m abx_tpu_torch.tools.profile_design [--num_t 100] \
        [--profile_t 2] [--out build/profile_design.json]

In one process, for ESM-off design and for design conditioned on ESM2-3B
(random weights made on the card; `--configs esm_off` runs the first
alone): the released config, bf16, B=4 samples
of testdata/6ct7_H_L_S.pdb (L = 256 + 32).  After one warm-up trajectory
each, it times whole trajectories at --num_t in turns (off, on, on, off)
and reports seconds per diffusion step and samples/hour; times one ESM2-3B
forward alone (CUDA events) with the attention through the hand-written
kernel, the flash route's hand-written segment-masked kernel
(ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1) and the plain version; and
traces a --profile_t trajectory of each with torch.profiler, printing the
device time by kernel name (the top 40, and every kernel of the port's
own library), the summed device time and the device kernels per trunk
pass.  Needs a CUDA device; writes the numbers as JSON to --out.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PDB = os.path.join(REPO, 'testdata', '6ct7_H_L_S.pdb')
MODEL_CONFIG = os.path.join(REPO, 'config', 'config_model.json')
BATCH = 4


def _card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _setup(esm: bool):
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    rt = runner.build_runtime(MODEL_CONFIG, seed=0, bf16=True, device='cuda',
                              esm_random=esm)
    feats, _ = next(runner.load_complexes(None, None, PDB, rt))
    batch = {k: np.repeat(v, BATCH, axis=0)
             for k, v in ds.stack_batch([feats]).items()}
    batch = to_device_batch(batch, rt.device)

    def sampler(num_t):
        return Sampler(rt.model, rt.diffuser, rt.config.model,
                       SamplerConfig(num_t=num_t), esm_fn=rt.esm)
    return rt, batch, sampler


def _trajectory_s(sampler, batch, seed: int) -> float:
    gen = torch.Generator(device='cuda').manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.time()
    sampler.sample(batch, gen)
    torch.cuda.synchronize()
    return time.time() - t0


def _profile(sampler, batch, passes: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _trajectory_s(sampler, batch, 7)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())
    count = sum(v[1] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {'wall_s': wall, 'device_ms': total, 'device_kernels': count,
            'device_ms_per_pass': total / passes,
            'kernels_per_pass': count / passes,
            'top': [{'name': k[:120], 'ms': v[0], 'calls': v[1]}
                    for k, v in ranked[:40]],
            # Every kernel of the port's library (namespace abx), however
            # small its share.
            'port': [{'name': k[:120], 'ms': v[0], 'calls': v[1]}
                     for k, v in ranked if 'abx::' in k]}


def _esm_forward_ms(rt, batch):
    """One ESM2-3B forward of the batch's antibody for each attention
    route: the routes in turns (kernel, flash, plain, plain, flash, kernel),
    each turn 2 warm-ups and 5 CUDA-event timings; the median of a route's
    10 timings."""
    l_ab = rt.model.antibody_len
    ab = batch['seq'][:, :l_ab]
    lw = rt.model.seqformer.esm_layer_weights()
    routes = {'kernel': {}, 'flash': {'ABX_FUSED_ESM_ATTN': '0',
                                      'ABX_FLASH_ESM': '1'},
              'plain': {'ABX_FUSED_ESM_ATTN': '0'}}
    times = collections.defaultdict(list)
    for route in ('kernel', 'flash', 'plain', 'plain', 'flash', 'kernel'):
        env = routes[route]
        os.environ.update(env)
        with torch.no_grad():
            for i in range(7):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rt.esm(ab, batch['heavy_len'], batch['light_len'], lw)
                end.record()
                torch.cuda.synchronize()
                if i >= 2:
                    times[route].append(start.elapsed_time(end))
        for k in env:
            os.environ.pop(k)
    return {route: statistics.median(ts) for route, ts in times.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--num_t', type=int, default=100)
    p.add_argument('--profile_t', type=int, default=2)
    p.add_argument('--out', default=os.path.join(REPO, 'build',
                                                 'profile_design.json'))
    p.add_argument('--configs', default='esm_off,esm_on',
                   help='which of esm_off, esm_on to run (comma-separated)')
    args = p.parse_args(argv)
    configs = args.configs.split(',')
    if not torch.cuda.is_available():
        raise SystemExit('profile_design: needs a CUDA device')
    card = _card()
    print(f'card: {card}', flush=True)
    runs = {name: _setup(name == 'esm_on') for name in configs}
    for name, (_, batch, sampler) in runs.items():
        _trajectory_s(sampler(4), batch, 0)          # warm-up
    steady = collections.defaultdict(list)
    for name in configs + configs[::-1]:
        _, batch, sampler = runs[name]
        s = _trajectory_s(sampler(args.num_t), batch, 1)
        per_step = s / (args.num_t + 1)
        steady[name].append(per_step)
        print(f'{name}: num_t {args.num_t}, {per_step:.4f} s per step, '
              f'{BATCH / s * 3600:.1f} samples/hour ({card})', flush=True)
    result = {'card': card, 'num_t': args.num_t,
              's_per_step': dict(steady),
              'samples_per_hour': {
                  k: [BATCH / (v * (args.num_t + 1)) * 3600 for v in vs]
                  for k, vs in steady.items()}}
    if 'esm_on' in runs:
        rt, batch, _ = runs['esm_on']
        result['esm_forward_ms'] = _esm_forward_ms(rt, batch)
        print(f'ESM2-3B forward (B=4, L=306) by attention route, ms: '
              f'{json.dumps(result["esm_forward_ms"])}', flush=True)
    rt = next(iter(runs.values()))[0]
    passes = (args.profile_t + 1) * (rt.config.model.num_recycle + 1)
    result['profile'] = {}
    for name, (_, batch, sampler) in runs.items():
        prof = _profile(sampler(args.profile_t), batch, passes)
        result['profile'][name] = prof
        print(f'{name} profile, num_t {args.profile_t} ({passes} trunk '
              f'passes): device {prof["device_ms"]:.2f} ms, '
              f'{prof["device_ms_per_pass"]:.2f} ms and '
              f'{prof["kernels_per_pass"]:.0f} kernels per pass, wall '
              f'{prof["wall_s"]:.3f} s', flush=True)
        for row in prof['top']:
            print(f'  {row["ms"]:9.2f} ms {row["calls"]:6d}  {row["name"]}')
        print('  the port\'s kernels:')
        for row in prof['port']:
            print(f'  {row["ms"]:9.3f} ms {row["calls"]:6d}  {row["name"]}')
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
