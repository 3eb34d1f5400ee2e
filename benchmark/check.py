"""The comparison that decides `correct`.

The reference (`benchmark/reference`) recomputes, in float32, each step
the window checked, from the step's own input state as the program held
it; see `reference/step.py`.  The numbers, each a widest gap over the
checked steps, so that one wrong element shows:

- `start`: the first trajectory's t = 1 state (rigids and sequence) against
  the reference's from the same generator seed: max |d rigids| / max
  |rigids|, plus the share of residues whose token differs (exact);
- `esm` (ESM2 configurations): the first pass's ESM2 embedding, max |d| /
  max |ref| over the antibody residues;
- `logits`: the final pass's amino-acid logits, max |d| / max |ref| over
  the complex's residues;
- `frames`: the final pass's predicted (denoised) frames over the diffused
  residues, the larger of the translations' max |d| / max |ref| and the
  largest rotation angle between program and reference, in radians;
- `update`: the stages after the network, each checked by itself against
  the reference applied to the program's own outputs and random draws,
  exactly: the rotation and translation scores from the program's
  predicted frames (max |d| / max |ref| each), and the reverse update on
  SO(3), R^3 and the amino-acid track from the program's scores, logits
  and recycled sequence (max |d rigids| over the largest move the update
  makes on the diffused residues, plus the share of diffused residues whose
  next token differs); the sum of the four.

The scores themselves are not compared with the reference's: they read
the IGSO(3) score-norm table by the bin of the rotation angle, so a
rounding that moves an angle across a bin edge changes them by a step
(PERF.md); the frames they derive from are compared instead.

Each number has a limit of its own (`benchmark/limits/<cell>.json`),
set from measured readings that PERF.md gives.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.capture import StepRecord

NUMBERS = ('start', 'esm', 'logits', 'frames', 'update')


def rel_max(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    """max |a - b| / max |b| over the elements where `mask` (broadcast
    over trailing axes) is set."""
    a, b = a.detach().float(), b.detach().float()
    d = (a - b).abs()
    r = b.abs()
    if mask is not None:
        m = mask.bool()
        while m.dim() < d.dim():
            m = m[..., None]
        m = m.expand_as(d)
        d, r = d[m], r[m]
    if d.numel() == 0:
        return 0.0
    return float(d.max() / r.max().clamp(min=1e-30))


def move_gap(prog_next, ref_next, before, mask) -> float:
    """max |d rigids| (quaternion and translation components) over the
    diffused residues, over the largest change the reference's update
    makes there."""
    m = mask.bool()
    d = (prog_next.float() - ref_next.float()).abs()[m]
    move = (ref_next.float() - before.float()).abs()[m]
    if d.numel() == 0:
        return 0.0
    return float(d.max() / move.max().clamp(min=1e-30))


def step_numbers(rec: StepRecord, ref: Dict, stages: Dict, device,
                 mask_res: torch.Tensor, diffuse: torch.Tensor
                 ) -> Dict[str, float]:
    """The numbers of one checked step: the program's copies in `rec`
    against the reference's outputs `ref`, and against `stages`, the
    reference's scores ('rot_score', 'trans_score') and update
    ('rigids_next', 'seq_next') from the program's own outputs."""
    def prog(k):
        return rec.get(k).to(device)
    frames = prog('frames')
    out = {
        'logits': rel_max(prog('logits'), ref['logits'], mask_res),
        'frames': max(rel_max(frames[..., 4:], ref['frames'][..., 4:],
                              diffuse),
                      angle_max(frames[..., :4], ref['frames'][..., :4],
                                diffuse)),
        'update': (rel_max(prog('rot_score'), stages['rot_score'], diffuse)
                   + rel_max(prog('trans_score'), stages['trans_score'],
                             diffuse)
                   + move_gap(prog('out.rigids_t'), stages['rigids_next'],
                              prog('in.rigids_t'), diffuse)
                   + token_share(prog('out.seq_t'), stages['seq_next'],
                                 diffuse)),
    }
    if ref['esm'] is not None:
        l_ab = ref['esm'].shape[1]
        out['esm'] = rel_max(prog('esm'), ref['esm'], mask_res[:, :l_ab])
    return out


def angle_max(q1: torch.Tensor, q2: torch.Tensor, mask) -> float:
    """The largest rotation angle between unit quaternions (..., 4) where
    `mask` is set, in radians."""
    q1, q2 = q1.float(), q2.float()
    sign = torch.where((q1 * q2).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    # 4 asin(|q1 - q2| / 2): well conditioned where the angle is small.
    chord = (q1 - sign * q2).norm(dim=-1)
    ang = (4.0 * torch.asin((chord / 2).clamp(max=1.0)))[mask.bool()]
    return float(ang.max()) if ang.numel() else 0.0


def token_share(a, b, mask) -> float:
    m = mask.bool()
    n = int(m.sum())
    return float(((a.long() != b.long()) & m).sum()) / max(n, 1)


def start_number(start_bufs: Dict, ref_prepared: Dict, device) -> float:
    rig = start_bufs['rigids_t'].to(device)
    seq = start_bufs['seq_t'].to(device)
    full = torch.ones_like(seq, dtype=torch.bool)
    return (rel_max(rig, ref_prepared['rigids_t'])
            + token_share(seq, ref_prepared['seq_t'], full))


def combine(per_step: List[Dict[str, float]]) -> Dict[str, float]:
    """The widest of each number over the checked steps."""
    out: Dict[str, float] = {}
    for d in per_step:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and every limited number present."""
    rows = []
    ok = True
    for k in NUMBERS:
        if k not in limits:
            continue
        v = numbers.get(k)
        good = v is not None and v == v and v <= limits[k]
        ok = ok and good
        rows.append((k, v, limits[k]))
    return ok, rows
