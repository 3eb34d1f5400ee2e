"""BENCHMARK.json against the contract's shape rules, and every cell,
configuration, traffic mix, limits file and reader found by name."""

import json
import os
import re

import pytest

from benchmark import check, manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
M = manifest.load_manifest()
CELLS = [w['name'] for w in M['workloads']]


def test_top_level_keys():
    assert set(M) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert M['paths'] == ['benchmark']
    assert 1 <= M['run_seconds'] <= 51
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024
    for word in M['command']:
        assert not word.startswith('/') and '..' not in word


def test_names_units_and_bounds():
    names = [c['name'] for c in M['configs']] + CELLS + \
        [m['name'] for m in M['end_to_end'] + M['per_layer']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M['end_to_end'] + M['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    e2e = {m['name']: m for m in M['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in M['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
    for m in M['per_layer']:
        assert m['moves'] in e2e
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}


def test_configs_files():
    for c in M['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/')
        with open(manifest.resolve(c['file']), encoding='utf-8') as f:
            json.load(f)
        assert any(w['config'] == c['name'] for w in M['workloads'])


@pytest.mark.parametrize('name', CELLS)
def test_cell_found_by_name(name):
    cell = manifest.find_cell(name)
    assert cell.chips == 1
    assert os.path.exists(manifest.resolve(cell.traffic['inputs']))
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.load_reader(m['name']))
    assert set(cell.limits) <= set(check.NUMBERS)
    assert 'esm' in cell.limits or cell.config_name != 'abx_esm2_3b'


def test_unknown_cell():
    with pytest.raises(KeyError):
        manifest.find_cell('no_such_cell')


def test_readers_return_nothing_without_a_trace():
    from benchmark.trace import TraceData
    for m in M['per_layer']:
        assert manifest.load_reader(m['name'])(TraceData()) is None
