"""The traced stretch of a `--trace 1` run: spans the harness opens around
the program's layers, `torch.profiler` over a few whole steps inside the
window, and the reduction of its events, kept in memory, to what the
per-layer readers (`benchmark/readers/`) read.

Spans: forward hooks on the program's module instances open a
`record_function` range named after the layer (`SPANS`); the harness
also opens `bench.step` around each step.  No file of the program is
changed.  A device operation belongs to a span when the host call that
launched it (linked by the profiler's correlation id) ran inside it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

# span name -> class name of the program's modules it wraps.
SPANS = {
    'bench.trunk': 'EmbeddingAndSeqformer',
    'bench.ipa': 'IpaScore',
    'bench.tri_attention': 'TriangleAttention',
    'bench.esm_self_attention': 'ESMSelfAttention',
    'bench.esm': 'AntibodyESM',
}
STEP_SPAN = 'bench.step'
_LAUNCH_WORDS = ('LaunchKernel', 'cuLaunch', 'GraphLaunch',
                 'LaunchCooperativeKernel')


class Spans:
    """Hooks opening a profiler range around every call of the wrapped
    modules, and the shapes of the calls that the roofline readers need
    (`calls[span]`: (input shape, heads) a call)."""

    def __init__(self, modules):
        self.calls: Dict[str, List[Tuple]] = collections.defaultdict(list)
        self._stack = []
        self._handles = []
        by_class = {v: k for k, v in SPANS.items()}
        for m in modules:
            for sub in m.modules():
                name = by_class.get(type(sub).__name__)
                if name is not None:
                    self._hook(sub, name)

    def _hook(self, module, name):
        def pre(mod, args):
            self.calls[name].append(_call_shape(mod, args))
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._stack.append(rf)

        def post(mod, args, output):
            self._stack.pop().__exit__(None, None, None)
        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def _call_shape(mod, args):
    x = args[0] if args and torch.is_tensor(args[0]) else None
    heads = None
    if hasattr(mod, 'attn') and hasattr(mod.attn, 'num_head'):
        heads = mod.attn.num_head
    return (tuple(x.shape) if x is not None else None, heads)


@dataclasses.dataclass
class Interval:
    start: int   # ns
    end: int
    name: str


@dataclasses.dataclass
class TraceData:
    """What a traced stretch yields, for the readers."""
    steps: int = 0
    window_s: float = 0.0          # host wall of the stretch
    busy_s: float = 0.0            # union of device operations
    launches: int = 0              # kernel-launch API calls
    device_s_in: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, List] = dataclasses.field(default_factory=dict)
    device_ops: List = dataclasses.field(default_factory=list)
    idle_gaps: List = dataclasses.field(default_factory=list)
    n_device_events: int = 0
    # the whole window, for mfu
    window_steps: int = 0
    window_wall_s: float = 0.0
    flops_per_step: float = 0.0


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return 'CUDA' in str(e.device_type()) or 'GPU' in str(e.device_type())


def reduce(prof, spans: Spans, steps: int, window_s: float) -> TraceData:
    """TraceData of a finished profile of `steps` steps."""
    evs = list(_events(prof))
    device, launches, host = [], {}, []
    for e in evs:
        start, dur = e.start_ns(), e.duration_ns()
        if _is_device(e):
            # The device side of a host range is an annotation, not an
            # operation.
            if not (e.name().startswith('bench.') or e.is_user_annotation()):
                device.append(e)
            continue
        name = e.name()
        if any(w in name for w in _LAUNCH_WORDS):
            launches[e.correlation_id()] = e
        host.append(Interval(start, start + dur, name))
    by_span: Dict[str, List[Interval]] = collections.defaultdict(list)
    for iv in host:
        if iv.name.startswith('bench.'):
            by_span[iv.name].append(iv)
    for ivs in by_span.values():
        ivs.sort(key=lambda iv: iv.start)
    starts = {k: [iv.start for iv in v] for k, v in by_span.items()}

    def inside(span, t):
        ivs = by_span.get(span)
        if not ivs:
            return False
        i = bisect.bisect_right(starts[span], t) - 1
        return i >= 0 and ivs[i].end >= t

    dev_s_in: Dict[str, float] = collections.defaultdict(float)
    op_time: Dict[str, float] = collections.defaultdict(float)
    busy: List[Tuple[int, int, Optional[object]]] = []
    for e in device:
        start, dur = e.start_ns(), e.duration_ns()
        op_time[e.name()] += dur * 1e-9
        launch = (launches.get(e.correlation_id())
                  or launches.get(e.linked_correlation_id()))
        busy.append((start, start + dur, launch))
        if launch is None:
            continue
        t = launch.start_ns()
        for span in by_span:
            if inside(span, t):
                dev_s_in[span] += dur * 1e-9
    busy.sort(key=lambda x: x[0])
    merged, gaps = [], []
    for s, e, launch in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
            continue
        if merged:
            gaps.append((s - merged[-1][1], merged[-1][1], s, launch))
        merged.append([s, e])
    busy_ns = sum(e - s for s, e in merged)
    gaps.sort(key=lambda g: -g[0])
    idle = [[_host_name(host, g[1], g[2], g[3]), g[0] * 1e-9]
            for g in gaps[:10]]
    ops = sorted(op_time.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(
        steps=steps, window_s=window_s, busy_s=busy_ns * 1e-9,
        launches=len(launches), device_s_in=dict(dev_s_in),
        calls={k: list(v) for k, v in spans.calls.items()},
        device_ops=[[k, v] for k, v in ops], idle_gaps=idle,
        n_device_events=len(device))


def _host_name(host: List[Interval], g0: int, g1: int, launch) -> str:
    """The host spans and op open in the middle of a device gap (the
    innermost `bench.` span and the innermost op), or failing that the op
    that launched the work after it."""
    mid = (g0 + g1) // 2
    open_ = [iv for iv in host if iv.start <= mid <= iv.end
             and not any(w in iv.name for w in _LAUNCH_WORDS)]
    spans = [iv for iv in open_ if iv.name.startswith('bench.')]
    ops = [iv for iv in open_ if not iv.name.startswith('bench.')]
    parts = []
    if spans:
        parts.append(min(spans, key=lambda iv: iv.end - iv.start).name)
    if ops:
        parts.append(min(ops, key=lambda iv: iv.end - iv.start).name)
    if not parts and launch is not None:
        parts.append('before ' + launch.name())
    return ' > '.join(parts) or 'unattributed'
