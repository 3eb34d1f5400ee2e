"""The plain reference against the port at a tiny size in float32: the
check's numbers of a run of the port in float32 are at rounding level,
and those of the port in bfloat16 (as the cells run it) are below the
float8 control's."""

import json
import os

import torch

from benchmark import cell as cell_lib
from benchmark.tests.tiny import tiny_cell

SEED = 3_000_000_017


def _f32(cell, tmp_path):
    with open(cell.config_path, encoding='utf-8') as f:
        cfg = json.load(f)
    cfg['compute_dtype'] = 'float32'
    path = os.path.join(str(tmp_path), 'tiny_f32.json')
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(cfg, f)
    cell.config_path = path
    return cell


def _numbers(cell, seed, control=False):
    dev = torch.device('cpu')
    prog = cell_lib.Program(cell.config_path, cell.traffic, seed, dev)
    cap = cell_lib.warm_up(prog, seed, cell_lib.check_steps(seed,
                                                            cell.traffic))
    cell_lib.window(prog, cap, seed, float('inf'), max_steps=4)
    cell_lib.release(prog, cap)
    return cell_lib.run_check(cell.config_path, cell.traffic, seed, cap,
                              dev, control=control)


def test_reference_matches_the_port_in_float32(tmp_path):
    cell = _f32(tiny_cell(tmp_path), tmp_path)
    numbers, _ = _numbers(cell, SEED)
    assert numbers['start'] == 0.0
    for k in ('esm', 'logits', 'frames'):
        assert numbers[k] < 1e-4, (k, numbers)
    assert numbers['update'] == 0.0


def test_reference_matches_the_port_without_esm(tmp_path):
    cell = _f32(tiny_cell(tmp_path, esm=False), tmp_path)
    numbers, _ = _numbers(cell, SEED + 1)
    assert 'esm' not in numbers
    for k in ('logits', 'frames'):
        assert numbers[k] < 1e-4, (k, numbers)
    assert numbers['update'] == 0.0


def test_bf16_port_reads_below_the_float8_control(tmp_path):
    cell = tiny_cell(tmp_path)
    numbers, ctrl = _numbers(cell, SEED + 2, control=True)
    for k in ('esm', 'logits', 'frames'):
        assert numbers[k] < ctrl[k], (k, numbers, ctrl)
    assert ctrl['logits'] > 3 * numbers['logits']
