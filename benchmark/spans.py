"""The program's own spans in a traced stretch.

The port opens a host range named `abx.*` at each of its layer boundaries
while a profiler records (`abx_tpu_torch/utils/prof.py::annotate`): the
sampler step, each recycle pass, the update after the last pass, ESM2
and its sub-layers, the trunk and its sub-layers, IPA and the heads.
This module reduces them on the profile's one clock, as `trace.py` does
the harness's `bench.` spans: for each name its calls, host time, the
device time of the operations launched inside it (with and without what
its child `abx.` spans launched), its launch API calls and the device
idle time whose gap's midpoint lies inside it; the longest gaps named
`<innermost bench. span> > <innermost abx. span> > <innermost op>`; the
device operations with the most time, each named by the innermost `abx.`
span that launched it; and the per-layer numbers these give
(`numbers`).

`trace.reduce` does not call this module, so no metric of
`BENCHMARK.json` reads it; `benchmark/tools/span_table.py` prints it for
a cell's traced stretch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.trace import _LAUNCH_WORDS, _is_device

PREFIX = 'abx.'
STEP, PASS, ESM = 'abx.step', 'abx.pass', 'abx.esm'


@dataclasses.dataclass
class SpanStats:
    """One span name over the stretch (times in ms)."""
    calls: int = 0
    host_ms: float = 0.0          # inclusive, summed over the calls
    device_ms: float = 0.0        # launched inside, children included
    self_device_ms: float = 0.0   # less what child `abx.` spans launched
    launches: int = 0             # launch API calls inside
    idle_ms: float = 0.0          # device gaps whose midpoint is inside


@dataclasses.dataclass
class ProgramSpans:
    spans: Dict[str, SpanStats] = dataclasses.field(default_factory=dict)
    # device idle inside `abx.step` and outside every `abx.pass` and
    # `abx.esm`: the sampler's own work around the passes
    sampler_idle_ms: float = 0.0
    idle_gaps: List = dataclasses.field(default_factory=list)
    # [`<innermost abx. span> > <operation>`, s] of the 10 with most time
    device_ops: List = dataclasses.field(default_factory=list)


Range = Tuple[int, int, str]   # start ns, end ns, name


def reduce_events(evs: Sequence) -> ProgramSpans:
    """ProgramSpans of a profile's kineto events."""
    host: List[Range] = []
    launches: Dict[int, int] = {}      # correlation id -> host start
    device = []                # (start, end, name, correlation ids)
    for e in evs:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if _is_device(e):
            if not (e.is_user_annotation()
                    or name.startswith(('bench.', PREFIX))):
                device.append((start, end, name, e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        if any(w in name for w in _LAUNCH_WORDS):
            launches[e.correlation_id()] = start
        else:
            host.append((start, end, name))
    spans = [r for r in host if r[2].startswith(PREFIX)]
    out = ProgramSpans()
    stats = out.spans
    for s, e, name in spans:
        st = stats.setdefault(name, SpanStats())
        st.calls += 1
        st.host_ms += (e - s) * 1e-6

    launch_t = list(launches.values())
    for names in _open_at(spans, launch_t):
        for name in set(names):
            stats[name].launches += 1

    ops = []
    for s, e, op, corr, linked in device:
        t = launches.get(corr, launches.get(linked))
        if t is not None:
            ops.append((t, (e - s) * 1e-6, op))
    by_op: Dict[str, float] = {}
    for (_, ms, op), names in zip(ops, _open_at(spans, [o[0] for o in ops])):
        for name in set(names):
            stats[name].device_ms += ms
        if names:
            stats[names[-1]].self_device_ms += ms
        key = f'{names[-1] if names else "outside"} > {op[:60]}'
        by_op[key] = by_op.get(key, 0.0) + ms * 1e-3
    out.device_ops = sorted(([k, v] for k, v in by_op.items()),
                            key=lambda kv: -kv[1])[:10]

    gaps = _gaps([(s, e) for s, e, _, _, _ in device])
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    for (g0, g1), names in zip(gaps, _open_at(spans, mids)):
        ms = (g1 - g0) * 1e-6
        for name in set(names):
            stats[name].idle_ms += ms
        if STEP in names and PASS not in names and ESM not in names:
            out.sampler_idle_ms += ms
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    out.idle_gaps = [[_gap_name(host, g0, g1), (g1 - g0) * 1e-9]
                     for g0, g1 in longest]
    return out


def _open_at(ranges: Sequence[Range], times: Sequence[int]
             ) -> List[List[str]]:
    """For each time, the names of the ranges open at it (start <= t <=
    end), outermost first: one sweep over the sorted bounds."""
    marks = []
    for i, (s, e, _) in enumerate(ranges):
        marks.append((s, 0, i))
        marks.append((e, 2, i))
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks.sort()
    open_: Dict[int, Range] = {}
    out: List[List[str]] = [[] for _ in times]
    for _, kind, i in marks:
        if kind == 0:
            open_[i] = ranges[i]
        elif kind == 2:
            open_.pop(i, None)
        elif open_:
            out[i] = [r[2] for r in sorted(open_.values(),
                                           key=lambda r: (r[0], -r[1]))]
    return out


def _gaps(busy: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The gaps between the union of the device intervals, as
    `trace.reduce` merges them."""
    merged: List[List[int]] = []
    gaps = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
            continue
        if merged:
            gaps.append((merged[-1][1], s))
        merged.append([s, e])
    return gaps


def _gap_name(host: Sequence[Range], g0: int, g1: int) -> str:
    """`<innermost bench. span> > <innermost abx. span> > <innermost op>`
    open at the gap's midpoint, the parts that exist."""
    mid = (g0 + g1) // 2
    open_ = [r for r in host if r[0] <= mid <= r[1]]
    parts = []
    for keep in (lambda n: n.startswith('bench.'),
                 lambda n: n.startswith(PREFIX),
                 lambda n: not n.startswith(('bench.', PREFIX))):
        found = [r for r in open_ if keep(r[2])]
        if found:
            parts.append(min(found, key=lambda r: r[1] - r[0])[2])
    return ' > '.join(parts) or 'unattributed'


def numbers(data: ProgramSpans) -> Dict[str, Optional[float]]:
    """The per-layer numbers the spans give (None where a span is absent):
    launches a pass, the sampler's idle ms a step (`sampler_idle_ms`), the
    idle ms a step inside ESM2, and the device ms a step launched inside
    ESM2's LayerNorms, its weighted sum and the triangle
    multiplications."""
    sp = data.spans
    steps = sp[STEP].calls if STEP in sp else 0

    def per_step(name, field):
        if not steps or name not in sp:
            return None
        return getattr(sp[name], field) / steps

    passes = sp.get(PASS)
    return {
        'launches_per_pass': (passes.launches / passes.calls
                              if passes else None),
        'sampler_idle_ms_per_step': (data.sampler_idle_ms / steps
                                     if steps else None),
        'esm_idle_ms_per_step': per_step(ESM, 'idle_ms'),
        'esm_norm_device_ms_per_step': per_step('abx.esm.norm', 'device_ms'),
        'esm_mix_device_ms_per_step': per_step('abx.esm.mix', 'device_ms'),
        'tri_mult_device_ms_per_step': per_step('abx.trunk.tri_mult',
                                                'device_ms'),
    }


def table(data: ProgramSpans) -> List[str]:
    """One line a span, each number a step (÷ the `abx.step` calls)."""
    sp = data.spans
    steps = sp[STEP].calls if STEP in sp else 0
    if not steps:
        return ['no abx. spans in the stretch']
    lines = ['span: calls, host ms, device ms self / inclusive, launches, '
             f'idle ms (a step, {steps} steps)']
    for name in sorted(sp):
        st = sp[name]
        lines.append(
            f'{name}: {st.calls / steps:g}, {st.host_ms / steps:.3f}, '
            f'{st.self_device_ms / steps:.3f} / {st.device_ms / steps:.3f}, '
            f'{st.launches / steps:g}, {st.idle_ms / steps:.3f}')
    lines.append(f'sampler idle (in abx.step, outside abx.pass and abx.esm):'
                 f' {data.sampler_idle_ms / steps:.3f}')
    return lines
