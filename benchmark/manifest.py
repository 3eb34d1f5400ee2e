"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's `file` is its sizes, the traffic mix is
`benchmark/traffic/<traffic>.json`, each per-layer metric's reader is
`benchmark/readers/<metric>.py`, and each cell's correctness limits are
`benchmark/limits/<cell>.json`.  A later change adds a cell, a
configuration, a traffic mix or a metric by adding such files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, 'BENCHMARK.json')


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config_path: str
    traffic_name: str
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict


def resolve(path: str) -> str:
    """A path of the manifest or a traffic file, relative to the root."""
    return path if os.path.isabs(path) else os.path.join(ROOT, path)


def load_manifest(path: str = MANIFEST) -> Dict:
    with open(path, 'r', encoding='utf-8') as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def traffic_path(name: str) -> str:
    return os.path.join(HERE, 'traffic', name + '.json')


def limits_path(cell: str) -> str:
    return os.path.join(HERE, 'limits', cell + '.json')


def reader_path(metric: str) -> str:
    return os.path.join(HERE, 'readers', metric + '.py')


def find_cell(name: str, manifest: Optional[Dict] = None) -> Cell:
    """The cell called `name`, with its configuration, traffic, metrics and
    limits; raises KeyError for a name the manifest lacks."""
    m = manifest or load_manifest()
    work = {w['name']: w for w in m['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                       f'(have: {sorted(work)})')
    w = work[name]
    configs = {c['name']: c for c in m['configs']}
    cfg = configs[w['config']]
    with open(traffic_path(w['traffic']), 'r', encoding='utf-8') as f:
        traffic = json.load(f)
    with open(limits_path(name), 'r', encoding='utf-8') as f:
        limits = json.load(f)
    return Cell(
        name=name, config_name=cfg['name'],
        config_path=os.path.join(ROOT, cfg['file']),
        traffic_name=w['traffic'], traffic=traffic, chips=int(w['chips']),
        end_to_end=[e for e in m['end_to_end'] if _applies(e, name)],
        per_layer=[p for p in m['per_layer'] if _applies(p, name)],
        limits=limits)


def load_reader(metric: str) -> Callable:
    """The `read(trace_ctx)` function of `benchmark/readers/<metric>.py`."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        'benchmark.readers.' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
