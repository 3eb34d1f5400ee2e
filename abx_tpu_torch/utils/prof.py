"""Tracing / profiling utilities (counterpart of abx_tpu/utils/prof.py).

Provides:
  * `phase(name)` -- context manager accumulating wall-time per phase
    (data / prepare / sample / postprocess), reported by `summary()`;
  * `trace(log_dir)` -- a `torch.profiler.profile` over the CPU and, where
    there is one, the card, written as a Chrome trace into `log_dir`;
  * `annotate(name)` / `annotated(name)` -- a named span of the program
    (`torch.profiler.record_function`) while a profiler records, nothing
    otherwise.
`phase`, `summary` and `trace` are tools for a caller.  The main path
opens `annotate` spans at its layer boundaries, all named `abx.*`:
`abx.step` (one `Sampler.step`), `abx.pass` (each pass of
`forward_with_recycling`), `abx.update` (the step's work after its last
pass), `abx.esm` with `.norm` / `.attn` / `.ffn` / `.mix` (ESM2),
`abx.trunk` with `.embed` / `.seq_attn` / `.transition` / `.opm` /
`.tri_mult` / `.tri_attn`, `abx.ipa` with `.attn`, and `abx.heads`.
Under `trace(dir)` they land in the Chrome trace on the clock of the
kernels they launch; under `torch.autograd.profiler.emit_nvtx()` (Nsight
Systems) `record_function` emits them as NVTX ranges.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time
from typing import Dict

import torch

_PHASES: Dict[str, float] = collections.defaultdict(float)
_COUNTS: Dict[str, int] = collections.defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def summary(reset: bool = False) -> Dict[str, dict]:
    out = {k: {'total_s': round(v, 4), 'count': _COUNTS[k],
               'mean_s': round(v / max(_COUNTS[k], 1), 4)}
           for k, v in _PHASES.items()}
    if reset:
        _PHASES.clear()
        _COUNTS.clear()
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit the Chrome trace is written to
    `<log_dir>/trace.json` and the profiler is yielded for its
    `key_averages()`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span while a profiler records (`torch.profiler.profile`,
    `trace`, `emit_nvtx`); otherwise a shared no-op context, after one
    check of the profiler's state and nothing built."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def annotated(name: str):
    """Decorator: the function's calls run inside `annotate(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap
