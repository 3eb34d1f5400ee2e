"""One run of one cell: set-up, warm-up, the measured window (with the
traced stretch when asked), and the correctness check.

The window drives the program's design sampler
(`abx_tpu_torch.sampling.sampler.Sampler`) as `Sampler.sample` does:
`prepare`, then `step` at every grid position, for back-to-back batches
of the traffic's `batch` samples of one complex, trajectory k seeded with
seed + k, until `seconds` have passed; the step running then is the last.
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check as check_lib
from benchmark import manifest as manifest_lib
from benchmark import trace as trace_lib
from benchmark import weights as weights_lib
from benchmark import yardstick
from benchmark.capture import Capture

BANNED = ('jax', 'jaxlib', 'flax', 'abx_tpu')


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (`abx_tpu_torch` is not `abx_tpu`)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(BANNED))


def load_inputs(path: str, batch: int) -> Dict[str, np.ndarray]:
    """The input file's arrays, repeated to `batch` rows."""
    with np.load(path) as z:
        return {k: np.repeat(np.asarray(z[k])[None], batch, axis=0)
                for k in z.files}


def check_steps(seed: int, traffic: Dict) -> List[int]:
    """The window's steps that the check compares, drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    lo, hi = traffic['check_from'], traffic['check_below']
    return sorted(int(i) for i in rng.choice(np.arange(lo, hi),
                                             traffic['check_steps'],
                                             replace=False))


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


class Program:
    """The system under test, built from the configuration file through the
    port's runtime, with the benchmark's weights."""

    def __init__(self, config_path: str, traffic: Dict, seed: int,
                 device: torch.device):
        from abx_tpu_torch.cli import runner
        from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                    to_device_batch)
        from abx_tpu_torch.utils import params as params_lib
        with open(config_path, 'r', encoding='utf-8') as f:
            self.cfg = json.load(f)
        self.traffic = traffic
        self.device = device
        bf16 = self.cfg.get('compute_dtype', 'float32') == 'bfloat16'
        dtype = torch.bfloat16 if bf16 else torch.float32
        seeds = weights_lib.seeds(seed)
        rt = runner.build_runtime(config_path, bf16=bf16, device=str(device))
        trunk = weights_lib.make(weights_lib.spec_of(rt.model),
                                 seeds['trunk'], torch.float32, device)
        rt.model.load_state_dict(trunk, strict=True)
        del trunk
        if rt.config.model.embeddings_and_seqformer.esm.enabled:
            esm = runner._esm_module(rt.config, dtype)
            params_lib.load_esm_params(
                esm.module, weights_lib.make(weights_lib.spec_of(esm.module),
                                             seeds['esm'], dtype, device),
                device, dtype)
            rt.esm = esm.requires_grad_(False).eval()
        self.runtime = rt
        self.batch = int(traffic['batch'])
        self.feats = to_device_batch(
            load_inputs(manifest_lib.resolve(traffic['inputs']), self.batch),
            device)
        self.sampler = Sampler(
            rt.model, rt.diffuser, rt.config.model,
            SamplerConfig(num_t=int(traffic['num_t']),
                          generate_area=traffic['generate_area']),
            esm_fn=rt.esm)
        self.num_passes = rt.config.model.num_recycle + 1
        self.grid = len(self.sampler.step_grids()[0])

    def close(self) -> None:
        self.runtime = self.sampler = self.feats = None


@torch.no_grad()
def warm_up(prog: Program, seed: int, steps_to_check,
            trace: bool = False) -> Capture:
    """The shapes of the cell's traffic (prepare, the prime step, ordinary
    steps) run once, and the capture's host buffers allocated; with
    `trace`, one more step under the profiler and the spans, so that the
    profiler's own start-up falls in the set-up and not in the window."""
    traffic, sampler, b = prog.traffic, prog.sampler, prog.batch
    dev = prog.device
    cap = Capture(prog.runtime.model, prog.runtime.esm, steps_to_check, dev,
                  prog.num_passes)
    gen = torch.Generator(device=dev).manual_seed(
        weights_lib.seeds(seed)['warmup'])
    prepared = sampler.prepare(prog.feats, gen)
    cap.start(prepared)
    traj, state = sampler._start(prepared)
    n_warm = int(traffic['warmup_steps'])
    for s in range(n_warm):
        cap.before(-1, s, state, gen, force=s == n_warm - 1)
        state, _ = sampler.step(traj, state, np.full(b, s), gen)
        rec = cap.after(state)
    cap.records.clear()
    cap.allocate(rec)
    if trace:
        spans = trace_lib.Spans([prog.runtime.model]
                                + ([prog.runtime.esm] if prog.runtime.esm
                                   else []))
        with _profiler(dev):
            sampler.step(traj, state, np.full(b, n_warm), gen)
            _sync(dev)
        spans.remove()
    _sync(dev)
    return cap


@torch.no_grad()
def window(prog: Program, cap: Capture, seed: int, seconds: float,
           trace: bool = False, max_steps: Optional[int] = None) -> Dict:
    """The measured window: trajectories of the traffic back to back until
    `seconds` have passed (or `max_steps` steps), with the traced stretch
    when `trace`.  Returns its counts and times."""
    traffic, sampler, b = prog.traffic, prog.sampler, prog.batch
    dev = prog.device
    cuda = dev.type == 'cuda'
    events = [torch.cuda.Event(enable_timing=True) for _ in range(1024)] \
        if cuda else []
    trace_from = int(traffic['trace_from'])
    trace_to = trace_from + int(traffic['trace_steps'])
    prof = spans = None
    tracing = False
    tr_t0 = tr_wall = 0.0
    step_host: List[float] = []
    _sync(dev)
    t0 = time.perf_counter()
    idx, k, done = 0, 0, False
    while not done:
        gen = torch.Generator(device=dev).manual_seed(int(seed) + k)
        prepared = sampler.prepare(prog.feats, gen)
        if k == 0:
            cap.start(prepared)
        traj, state = sampler._start(prepared)
        for s in range(prog.grid):
            if (time.perf_counter() - t0 >= seconds
                    or (max_steps is not None and idx >= max_steps)):
                done = True
                break
            if trace and idx == trace_from:
                _sync(dev)
                spans = trace_lib.Spans([prog.runtime.model]
                                        + ([prog.runtime.esm]
                                           if prog.runtime.esm else []))
                prof = _profiler(dev)
                prof.__enter__()
                tracing = True
                tr_t0 = time.perf_counter()
            cap.before(idx, s, state, gen)
            if cuda:
                while len(events) < 2 * idx + 2:
                    events.append(torch.cuda.Event(enable_timing=True))
                events[2 * idx].record()
            h0 = time.perf_counter()
            with (torch.profiler.record_function(trace_lib.STEP_SPAN)
                  if tracing else contextlib.nullcontext()):
                state, _ = sampler.step(traj, state, np.full(b, s), gen)
            if cuda:
                events[2 * idx + 1].record()
            step_host.append(time.perf_counter() - h0)
            cap.after(state)
            idx += 1
            if tracing and idx == trace_to:
                tr_wall = _close_trace(prof, spans, dev, tr_t0)
                tracing = False
        # The trajectory is done with: its state goes before the next
        # one's is made, as a design job's next batch would find it.
        del traj, state, prepared
        k += 1
    _sync(dev)
    window_s = time.perf_counter() - t0
    if tracing:
        tr_wall = _close_trace(prof, spans, dev, tr_t0)
    cap.finish()
    out = {'steps': idx, 'window_s': window_s, 't0': t0,
           'host_ms': [1e3 * x for x in step_host]}
    if cuda:
        out['step_ms'] = [events[2 * i].elapsed_time(events[2 * i + 1])
                          for i in range(idx)]
        out['peak'] = torch.cuda.max_memory_allocated(dev)
        out['kind'] = torch.cuda.get_device_name(dev)
    else:
        out['step_ms'] = [1e3 * x for x in step_host]
        out['peak'], out['kind'] = 0, 'cpu'
    out['traced'] = None
    if prof is not None:
        n_traced = min(trace_to, idx) - trace_from
        traced = trace_lib.reduce(prof, spans, n_traced, tr_wall)
        traced.window_steps = idx - n_traced
        traced.window_wall_s = window_s - tr_wall
        traced.flops_per_step = yardstick.flops_per_step(
            prog.cfg, b, int(prog.feats['seq'].shape[1]))
        out['traced'] = traced
    return out


def release(prog: Program, cap: Capture) -> None:
    """Drop the program (its weights and state) before the reference runs."""
    cap.model = cap.esm = None
    prog.close()
    gc.collect()
    if prog.device.type == 'cuda':
        torch.cuda.empty_cache()


def run(cell: manifest_lib.Cell, seed: int, seconds: float, trace: bool,
        device: str = 'cuda', t_process: Optional[float] = None,
        program_hook=None, max_steps: Optional[int] = None) -> Dict:
    """The result of one run (the dict `run.py` prints as its last line).
    For tests: `program_hook(program)` may alter the program once it is
    built, and `max_steps` ends the window after that many steps."""
    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = Program(cell.config_path, cell.traffic, seed, dev)
    if program_hook is not None:
        program_hook(prog)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    cap = warm_up(prog, seed, check_steps(seed, cell.traffic), trace)
    win = window(prog, cap, seed, seconds, trace, max_steps)
    setup_s = win['t0'] - t_process
    steps, b, grid = win['steps'], prog.batch, prog.grid
    release(prog, cap)
    del prog

    numbers, _ = run_check(cell.config_path, cell.traffic, seed, cap, dev)
    correct, rows = check_lib.verdict(numbers, cell.limits)

    _diagnose(win)
    metrics: Dict[str, Dict] = {}
    traced = win['traced']
    if not trace:
        values = {
            'designs_per_hour': steps * b * 3600.0 / (grid * win['window_s']),
            'step_ms_p90': _p90(win['step_ms']),
            'peak_mem_gib': win['peak'] / 2 ** 30,
            'setup_s': setup_s,
        }
        for m in cell.end_to_end:
            if m['name'] in values:
                metrics[m['name']] = {'value': values[m['name']],
                                      'unit': m['unit']}
    else:
        for m in cell.per_layer:
            v = (manifest_lib.load_reader(m['name'])(traced)
                 if traced is not None else None)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    result = {
        'correct': bool(correct),
        'attempted': steps,
        'failed': 0,
        'metrics': metrics,
        'device': {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                   'kind': win['kind'], 'count': 1,
                   'memory_peak_bytes': win['peak']},
    }
    if trace and traced is not None:
        result['device'].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result['breakdown'] = {'device_ops': traced.device_ops,
                               'idle_gaps': traced.idle_gaps}
    result['checked'] = {name: {'value': v, 'limit': lim}
                         for name, v, lim in rows}
    return result


def run_check(config_path: str, traffic: Dict, seed: int, cap: Capture,
              dev: torch.device, control: bool = False):
    """(numbers, control numbers): `check.py`'s numbers for the steps `cap`
    recorded, against the reference built on `dev` with the weights drawn
    again from the seed; with `control`, also those of the control, the
    reference in float8 (`reference.modules.precision('fp8')`) put in the
    program's place on the same inputs (else None)."""
    from benchmark.reference.modules import precision
    from benchmark.reference.step import Reference
    ref = build_reference(config_path, seed, dev)
    feats = _feats(traffic, dev)
    prep = ref.prepare(feats, torch.Generator(device=dev).manual_seed(
        int(seed)), traffic['generate_area'])
    numbers = {'start': check_lib.start_number(cap.start_bufs, prep, dev)}
    per_step, per_step_ctrl = [], []
    mask, diffuse = prep['mask'], Reference.diffuse_mask(prep)
    for i in sorted(cap.records):
        rec = cap.records[i]
        state, forced = _state(rec, dev), _forced(rec, dev)
        args = (prep, state, rec.position, int(traffic['num_t']),
                rec.generator_state, forced)
        out = ref.step(*args)
        last = forced[-1]['seq_t'] if forced and forced[-1] else \
            state['seq_t']
        rot, trans = ref.scores(state['rigids_t'],
                                rec.get('frames').to(dev), rec.position,
                                int(traffic['num_t']))
        rigids, seq = ref.update(prep, state['rigids_t'], last,
                                 rec.get('rot_score').to(dev),
                                 rec.get('trans_score').to(dev),
                                 rec.get('logits').to(dev), rec.position,
                                 int(traffic['num_t']), rec.generator_state)
        stages = {'rot_score': rot, 'trans_score': trans,
                  'rigids_next': rigids, 'seq_next': seq}
        per_step.append(check_lib.step_numbers(rec, out, stages, dev, mask,
                                               diffuse))
        if control:
            with precision('fp8'):
                low = ref.step(*args)
            per_step_ctrl.append(check_lib.step_numbers(
                _as_record(low, state), out, low, dev, mask, diffuse))
            del low
        del out
    numbers.update(check_lib.combine(per_step))
    ctrl = check_lib.combine(per_step_ctrl) if control else None
    return numbers, ctrl


def _as_record(out: Dict, state: Dict):
    """A reference step's outputs in the shape of the program's record."""
    from benchmark.capture import StepRecord
    rec = StepRecord()
    rec.bufs = {'logits': out['logits'], 'frames': out['frames'],
                'rot_score': out['rot_score'],
                'trans_score': out['trans_score'],
                'out.rigids_t': out['rigids_next'],
                'out.seq_t': out['seq_next'],
                'in.rigids_t': state['rigids_t']}
    if out['esm'] is not None:
        rec.bufs['esm'] = out['esm']
    return rec


def build_reference(config_path: str, seed: int, dev: torch.device):
    """The reference with the run's weights, drawn again from the seed."""
    from benchmark.reference.step import Reference
    with open(config_path, 'r', encoding='utf-8') as f:
        cfg = json.load(f)
    esm_dtype = (torch.bfloat16 if cfg.get('compute_dtype') == 'bfloat16'
                 else torch.float32)
    seeds = weights_lib.seeds(seed)
    ref = Reference(config_path, dev)
    ref.load(weights_lib.make(ref.trunk_spec(), seeds['trunk'],
                              torch.float32, dev),
             weights_lib.make(ref.esm_spec(), seeds['esm'], esm_dtype, dev)
             if ref.esm is not None else None)
    return ref


def _feats(traffic: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The input arrays on `dev`: floats as float32, integers as int64."""
    out = {}
    for k, v in load_inputs(manifest_lib.resolve(traffic['inputs']),
                            int(traffic['batch'])).items():
        out[k] = torch.tensor(v, dtype=torch.float32 if v.dtype.kind == 'f'
                              else torch.int64, device=dev)
    return out


def _state(rec, dev) -> Dict[str, torch.Tensor]:
    return {k: rec.get('in.' + k).to(dev) for k in Capture.STATE}


def _forced(rec, dev):
    return [None if f is None else {k: rec.get(v).to(dev)
                                    for k, v in f.items()}
            for f in rec.forced]


def _diagnose(win: Dict) -> None:
    """Where the window's time went, on standard error: step times on the
    device's clock and the host's enqueue time a step, by decile."""
    def q(v):
        return ' '.join(f'{x:.1f}' for x in np.percentile(
            np.asarray(v, np.float64), [10, 50, 90, 100]))
    if win['steps']:
        print(f'window: {win["steps"]} steps in {win["window_s"]:.3f} s; '
              f'step ms p10/p50/p90/max {q(win["step_ms"])}; host ms a step '
              f'{q(win["host_ms"])}', file=sys.stderr)
        slow = [i for i, v in enumerate(win['step_ms'])
                if v > 1.25 * float(np.median(win['step_ms']))]
        print(f'steps over 1.25x the median: {len(slow)} {slow[:40]}',
              file=sys.stderr)


def _p90(values: List[float]) -> float:
    """The 90th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 90))


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _close_trace(prof, spans, dev: torch.device, t0: float) -> float:
    """Ends the traced stretch once its work has finished; its wall."""
    _sync(dev)
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    spans.remove()
    return wall
