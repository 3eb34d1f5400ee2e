"""The control on the card, at a cell's own size: the float8 reference put
in the program's place fails the cell's limits, and the program passes
them, on one seed a cell.  Marked `gpu`; run on the card with

    python3 -m pytest benchmark/tests -m gpu -q

The CPU test of the same comparison at a tiny size is in
test_bench_reference.py; the readings the limits were set from, on a
dozen seeds and more, come from `python3 -m benchmark.calibrate`."""

import json

import pytest

from benchmark import calibrate, check, manifest

CELLS = [w['name'] for w in manifest.load_manifest()['workloads']]


@pytest.mark.gpu
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_and_program_passes(cuda, name, tmp_path):
    out = tmp_path / 'cal.jsonl'
    assert calibrate.main(['--workload', name, '--seeds', '777000111',
                           '--control', '--out', str(out)]) == 0
    line = json.loads(out.read_text().splitlines()[-1])
    limits = manifest.find_cell(name).limits
    assert check.verdict(line['program'], limits)[0]
    ctrl = dict(line['control'], start=0.0)
    assert not check.verdict(ctrl, limits)[0]
