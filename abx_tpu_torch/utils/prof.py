"""Tracing / profiling utilities (counterpart of abx_tpu/utils/prof.py).

Provides:
  * `phase(name)` -- context manager accumulating wall-time per phase
    (data / prepare / sample / postprocess), reported by `summary()`;
  * `trace(log_dir)` -- a `torch.profiler.profile` over the CPU and, where
    there is one, the card, written as a Chrome trace into `log_dir`;
  * `annotate(name)` -- a named span (`torch.profiler.record_function`,
    plus an NVTX range when `device` is a CUDA device).
Nothing on the main path calls these; they are tools for a caller.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def annotate(name: str, device: Optional[torch.device] = None):
    """A named span in the profiler's trace; on a CUDA `device` also an
    NVTX range."""
    nvtx = device is not None and torch.device(device).type == 'cuda'
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
