"""A whole run (past the look for a card) of a tiny cell on the CPU, with
the timed path broken underneath: `correct` has to come out false for
each fault a design cell can have, and true for the sound program.  The
limits are the ESM2 cell's own (`benchmark/limits/`).  (A fault in the
exchange between chips does not apply: every cell runs on one chip.)"""

import json

import numpy as np
import pytest

from benchmark import cell as cell_lib
from benchmark import manifest
from benchmark.tests.tiny import tiny_cell

LIMITS = manifest.limits_path('abx_esm2_3b.design_h3.b16')


def _limits():
    with open(LIMITS, encoding='utf-8') as f:
        return json.load(f)


def _run(tmp_path, hook=None):
    cell = tiny_cell(tmp_path, limits=_limits())
    return cell_lib.run(cell, 4_100_000_003, float('inf'), False, 'cpu',
                        program_hook=hook, max_steps=4)


def _wrap_step(prog, fn):
    orig = prog.sampler.step

    def step(traj, state, positions, generator, noise=None):
        new, out = orig(traj, state, positions, generator, noise)
        return fn(state, new), out
    prog.sampler.step = step


def state_unchanged(prog):
    """A step that returns its state unchanged."""
    _wrap_step(prog, lambda old, new: dict(old))


def half_batch(prog):
    """Half of the batch left out: the model's outputs for the second half
    of the rows are the mean of the first half's."""
    def hook(module, args, output):
        f = output['heads']['folding']
        s = output['heads']['sequence_module']
        for t in (f['rot_score'], f['trans_score'], s['logits']):
            h = t.shape[0] // 2
            t[h:] = t[:h].mean(0, keepdim=True)
    prog.runtime.model.register_forward_hook(hook)


def token_altered(prog):
    """One token's logit altered where the sequence head produces it."""
    def hook(module, args, output):
        logits = output['heads']['sequence_module']['logits']
        logits[0, 100, 3] += 4.0 * logits.abs().max()
    prog.runtime.model.register_forward_hook(hook)


def answer_altered(prog):
    """One residue's next coordinates altered where the update makes them."""
    def fn(old, new):
        new = dict(new)
        r = new['rigids_t'].clone()
        r[0, 100, 4:] += 1.0
        new['rigids_t'] = r
        return new
    _wrap_step(prog, fn)


def test_sound_program_is_correct(tmp_path):
    assert _run(tmp_path)['correct'] is True


@pytest.mark.parametrize('fault', [state_unchanged, half_batch,
                                   token_altered, answer_altered])
def test_fault_is_not_correct(tmp_path, fault):
    result = _run(tmp_path, fault)
    assert result['correct'] is False, result['checked']


def test_fault_rows_are_diffused():
    # The altered residue (100) lies in the tiny cell's diffused H3.
    with np.load(manifest.resolve('benchmark/inputs/6ct7_H_L_S.npz')) as z:
        anchors = np.nonzero(z['anchor_flag'] == 5)[0]
    assert anchors[0] < 100 < anchors[-1] - 1
