"""The port's bench (`abx_tpu_torch/tools/bench.py`) on the CPU: the tiny
model and ESM2 at num_t 1, one timed rep, one sample (BENCH_BATCH=1), prints
one JSON line with bench.py's keys and every config; without a card and
without `--device cpu` it raises.  Its times are CPU times and say nothing
of the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from abx_tpu_torch.tools import bench
from tests.torch_cpu_alloc import SUBPROCESS_ENV


def test_bench_tiny_cpu_prints_one_json_line():
    # One sample, one step, one torch thread and freed memory kept in the
    # process (tests/torch_cpu_alloc.py): the CPU run checks the output,
    # not a speed, and the trunk passes are nearly all of its time.
    env = dict(os.environ, BENCH_BATCH='1', OMP_NUM_THREADS='1',
               **SUBPROCESS_ENV)
    proc = subprocess.run(
        [sys.executable, '-m', 'abx_tpu_torch.tools.bench', '--device', 'cpu',
         '--tiny', '--num_t', '1', '--reps', '1'],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out['metric'] == 'design_samples_per_hour_per_chip'
    for key in ('value', 'unit', 'vs_baseline', 'detail'):
        assert key in out
    configs = out['detail']['configs']
    assert list(configs) == ['no_esm', 'esm', 'esm_reuse',
                             'esm_reuse_refresh8', 'fast_recipe_t25']
    for name, c in configs.items():
        assert 'error' not in c, (name, c)
        assert len(c['s_per_step']) == c['reps'] == 1
        assert c['s_per_step_median'] == c['s_per_step_min'] > 0
        assert c['s_per_step_spread'] == 0
        assert c['batch'] == 1 and c['samples_per_hr'] > 0
        assert c['mfu'] is None            # no device, no device metric
        assert c.get('output_changing_opt_in', False) == (name in bench.RUNGS)
    assert configs['fast_recipe_t25']['num_t'] == 1   # a quarter, >= 1
    assert out['value'] == configs['esm']['samples_per_hr']
    assert out['detail']['device']['name'] == 'cpu'


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.main([])


def test_bench_flops_count_the_esm_passes():
    per_step = bench.analytic_flops_per_step(True, 4)
    off = bench.analytic_flops_per_step(False, 4)
    reuse = bench.analytic_flops_per_step(True, 4, esm_passes=1.0)
    assert per_step > reuse > off > 0
    # Three ESM passes a step against one: the ESM share falls by 3.
    assert (per_step - off) == pytest.approx(3 * (reuse - off))
