"""`benchmark/spans.py` on a hand-built event list with known intervals,
launches and gaps; the readers of `BENCHMARK.json` reading the same
values with and without the program's `abx.` spans in the list; and the
span table of a tiny cell's traced stretch on the CPU
(`benchmark/tools/span_table.py`)."""

import types

import pytest

from benchmark import manifest
from benchmark import spans as spans_lib
from benchmark import trace as trace_lib
from benchmark.tests.tiny import tiny_cell
from benchmark.tools import span_table


class Ev:
    """A kineto event as `trace.reduce` and `spans.reduce_events` read
    it."""

    def __init__(self, name, start, end, device=False, corr=0,
                 annotation=False):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._corr = device, corr
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return 'DeviceType.CUDA' if self._device else 'DeviceType.CPU'

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._annotation


MS = 1_000_000   # ns

# One step of two passes, in ms on one clock: (span, start, end).
ABX = [('abx.step', 0, 100), ('abx.pass', 10, 40), ('abx.esm', 12, 30),
       ('abx.esm.norm', 13, 16), ('abx.esm.mix', 20, 22),
       ('abx.pass', 45, 80), ('abx.trunk', 46, 79),
       ('abx.trunk.tri_mult', 50, 60), ('abx.update', 82, 99)]
BENCH = [('bench.step', 0, 100), ('bench.esm', 12, 30),
         ('bench.esm_self_attention', 17, 19), ('bench.trunk', 46, 79),
         ('bench.tri_attention', 62, 70), ('bench.ipa', 71, 78)]
# Kernels: (launch at, runs from, to); a gap opens before each but the
# first.  Each lands in the span of its launch.
KERNELS = [(5, 6, 11),      # step, outside the passes
           (14, 14.5, 16),  # esm.norm
           (18, 18.5, 19.5),  # esm (bench.esm_self_attention)
           (21, 21.5, 22),  # esm.mix
           (25, 26, 33),    # esm
           (52, 53, 58),    # tri_mult
           (55, 58, 61),    # tri_mult
           (63, 64, 70),    # trunk (bench.tri_attention)
           (72, 73, 77),    # trunk (bench.ipa)
           (85, 86, 90)]    # update
# Gaps and the spans their midpoints fall in: 11-14.5 (12.75: esm),
# 16-18.5 (17.25: esm), 19.5-21.5 (20.5: esm.mix), 22-26 (24: esm),
# 33-53 (43: step only), 61-64 (62.5: trunk), 70-73 (71.5: trunk),
# 77-86 (81.5: step only).


def _events(with_abx=True):
    evs = [Ev(n, s * MS, e * MS) for n, s, e in BENCH]
    if with_abx:
        evs += [Ev(n, s * MS, e * MS) for n, s, e in ABX]
        # the device side of a host range is an annotation, not an op
        evs += [Ev('abx.pass', 11 * MS, 34 * MS, device=True,
                   annotation=True)]
    evs += [Ev('bench.step', 6 * MS, 90 * MS, device=True, annotation=True)]
    for i, (at, s, e) in enumerate(KERNELS):
        evs.append(Ev('cudaLaunchKernel', at * MS, int((at + 0.1) * MS),
                      corr=i + 1))
        evs.append(Ev(f'kernel_{i}', int(s * MS), int(e * MS), device=True,
                      corr=i + 1))
    return evs


def test_spans_give_calls_host_device_launches_and_idle():
    got = spans_lib.reduce_events(_events()).spans
    assert {k: v.calls for k, v in got.items()} == {
        n: sum(1 for m, _, _ in ABX if m == n) for n, _, _ in ABX}
    assert got['abx.pass'].host_ms == pytest.approx(30 + 35)
    assert got['abx.step'].launches == 10
    assert got['abx.pass'].launches == 8
    assert got['abx.esm'].launches == 4
    assert got['abx.update'].launches == 1
    assert got['abx.step'].device_ms == pytest.approx(5 + 1.5 + 1 + 0.5 + 7
                                                      + 5 + 3 + 6 + 4 + 4)
    assert got['abx.esm'].device_ms == pytest.approx(1.5 + 1 + 0.5 + 7)
    assert got['abx.esm'].self_device_ms == pytest.approx(1 + 7)
    assert got['abx.esm.norm'].device_ms == pytest.approx(1.5)
    assert got['abx.esm.mix'].device_ms == pytest.approx(0.5)
    assert got['abx.trunk.tri_mult'].device_ms == pytest.approx(5 + 3)
    assert got['abx.trunk'].self_device_ms == pytest.approx(6 + 4)
    assert got['abx.step'].self_device_ms == pytest.approx(5)
    assert got['abx.esm'].idle_ms == pytest.approx(3.5 + 2.5 + 2 + 4)
    assert got['abx.esm.mix'].idle_ms == pytest.approx(2)
    assert got['abx.pass'].idle_ms == pytest.approx(3.5 + 2.5 + 2 + 4
                                                    + 3 + 3)
    assert got['abx.step'].idle_ms == pytest.approx(12 + 20 + 6 + 9)


def test_sampler_idle_and_numbers():
    data = spans_lib.reduce_events(_events())
    assert data.sampler_idle_ms == pytest.approx(20 + 9)
    assert spans_lib.numbers(data) == pytest.approx({
        'launches_per_pass': 8 / 2, 'sampler_idle_ms_per_step': 29.0,
        'esm_idle_ms_per_step': 12.0, 'esm_norm_device_ms_per_step': 1.5,
        'esm_mix_device_ms_per_step': 0.5,
        'tri_mult_device_ms_per_step': 8.0})
    assert data.idle_gaps[0] == ['bench.step > abx.step', pytest.approx(
        0.020)]
    assert data.idle_gaps[2][0] == 'bench.esm > abx.esm'
    assert data.device_ops[:2] == [['abx.esm > kernel_4', pytest.approx(
        0.007)], ['abx.trunk > kernel_7', pytest.approx(0.006)]]
    assert len(data.spans) == len(spans_lib.table(data)) - 2


def test_numbers_and_table_are_empty_without_spans():
    for evs in ([], _events(with_abx=False)):
        data = spans_lib.reduce_events(evs)
        assert data.spans == {}
        assert set(spans_lib.numbers(data).values()) == {None}
        assert spans_lib.table(data) == ['no abx. spans in the stretch']


def _trace_data(evs):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    calls = {'bench.tri_attention': [((2, 64, 64, 32), 4)],
             'bench.esm_self_attention': [((2, 40, 256), None)]}
    data = trace_lib.reduce(prof, types.SimpleNamespace(calls=calls), 1,
                            0.1)
    data.window_steps, data.window_wall_s = 10, 1.0
    data.flops_per_step = 1e12
    return data


@pytest.mark.parametrize('metric', [m['name'] for m in
                                    manifest.load_manifest()['per_layer']])
def test_readers_read_the_same_with_the_program_spans(metric):
    read = manifest.load_reader(metric)
    want = read(_trace_data(_events(with_abx=False)))
    assert want is not None
    assert read(_trace_data(_events())) == want


def test_span_table_of_a_tiny_cell_on_the_cpu(tmp_path):
    cell = tiny_cell(tmp_path)
    row = span_table.traced_run(cell, 3_000_000_019, device='cpu')
    steps = cell.traffic['trace_steps']
    assert row['correct']
    assert len(row['step_host_ms']) == steps
    calls = {k: v['calls'] / steps for k, v in row['spans'].items()}
    assert calls['abx.step'] == 1 and calls['abx.pass'] == 3
    assert calls['abx.esm'] == 3 and calls['abx.esm.norm'] == 3 * 5
    assert calls['abx.update'] == 1 and calls['abx.trunk.tri_mult'] == 6
    assert row['numbers']['launches_per_pass'] == 0   # no card, no launch
    assert row['numbers']['esm_norm_device_ms_per_step'] == 0
    assert row['table'][0].startswith('span: ')
