"""Parallel-in-time (Picard) sampling: the reverse trajectory as a fixpoint.

Counterpart of abx_tpu/sampling/picard.py.  With every primitive noise draw
made up front (`draw_noise`, the injection `Sampler.sample_prepared(noise=)`
takes), the per-step transition is a deterministic map F, and the
sequential trajectory s_{i+1} = F(s_i, x_i) is the unique fixed point of
the parallel sweep

    S'[0]   = s_0
    S'[i+1] = F(S[i], x_i)        for ALL i at once (one batched step)

iterated from the trivial guess S[i] = s_0.  Sweep k fixes the prefix of
length k exactly, so the iteration reaches the sequential result in at most
grid-length sweeps (ParaDiGMS, Shih et al., 2023).

One sweep is one `Sampler.step` over every grid position: the states are
stacked on the batch axis (position-major, grid x B rows), so the trunk,
its kernels and `JointDiffuser.reverse` see grid x B rows, each with its
own t, t_model, prime flag and ESM-refresh flag.  Total work is sweeps x
the sequential work; the JAX package measured sweeps = num_t on the TPU
(a diverged tau-leap jump keeps every later position diverged until the
exact prefix reaches it), so this is a deterministic-replay capability,
not a latency lever.  Memory: the state of every grid position is alive at
once (prev_pair: grid x B x L x L x C_pair).

Exactness: run to `tol=0.0` the sweep-to-sweep change must vanish bit for
bit, so F draws nothing from a generator that advances between sweeps:
every reverse draw comes from `noise`, and the corrector's jumps from
uniforms fixed per position (drawn once from a generator seeded with 0,
as the JAX program splits a fixed key).  The result is the sequential
sampler's under the same noise up to the rounding of a batched matmul over
more rows.  With `mesh`, the time axis is split over the mesh's ranks
(padded with copies of the last position) and each sweep's states are
gathered.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from abx_tpu_torch.parallel import mesh as mesh_lib


def draw_noise(generator: torch.Generator, grid_len: int, batch: int,
               length: int, num_states: int = 20, corrector_steps: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """The primitive draws of a whole grid, as `JointDiffuser.reverse` makes
    them: per step 'rot_z' / 'trans_z' ~ N(0, 1) of (B, L, 3) and 'seq_u'
    ~ U[0, 1) of (B, L, S) (the Poisson jump counts come from the uniforms
    by inverse CDF), and with `corrector_steps` k, 'corr_u' (k, B, L, S)
    uniforms for the corrector's jumps.  `grid_len` is the FULL grid:
    num_t + 1 with the self-conditioning prime step (whose draws a
    discarded reverse consumes, as in the sequential sampler)."""
    dev = device if device is not None else generator.device
    g, b, l = grid_len, batch, length
    out = {
        'rot_z': torch.randn((g, b, l, 3), generator=generator, device=dev),
        'trans_z': torch.randn((g, b, l, 3), generator=generator,
                               device=dev),
        'seq_u': torch.rand((g, b, l, num_states), generator=generator,
                            device=dev),
    }
    if corrector_steps:
        out['corr_u'] = torch.rand((g, corrector_steps, b, l, num_states),
                                   generator=generator, device=dev)
    return out


def _max_abs_delta(a: Dict[str, torch.Tensor],
                   b: Dict[str, torch.Tensor]) -> float:
    """Max |a - b| over every entry (ints included), in f32: 0.0 iff the
    two are bitwise identical (no NaN)."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _tile(x: torch.Tensor, reps: int) -> torch.Tensor:
    """(B, ...) -> (reps * B, ...), position-major."""
    return x.repeat((reps,) + (1,) * (x.dim() - 1))


def _rows(x: torch.Tensor, pos, b: int) -> torch.Tensor:
    """The (len(pos) * B, ...) rows of positions `pos` of a (P * B, ...)
    stack."""
    idx = (torch.as_tensor(pos, device=x.device)[:, None] * b
           + torch.arange(b, device=x.device)[None]).reshape(-1)
    return x.index_select(0, idx)


@torch.no_grad()
def picard_sample(sampler, feats: Dict[str, torch.Tensor],
                  generator: torch.Generator,
                  noise: Optional[Dict[str, torch.Tensor]] = None,
                  max_sweeps: Optional[int] = None, tol: float = 0.0,
                  mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Any]:
    """Run `sampler`'s reverse process by parallel Picard iteration.

    Args:
        sampler: a `sampling.sampler.Sampler` (any mode; its `step` is
            the sequential sampler's step, so the numerics are the same).
        feats: the feature batch `Sampler.sample` takes; `generator`
            draws its initial noise (`Sampler.prepare`), and the per-step
            `noise` when none is given.
        noise: per-step draws with a leading grid axis (`draw_noise`).
        max_sweeps: sweep budget; default grid length + 1, by which the
            fixpoint is reached.
        tol: the sweep-to-sweep max-abs state change to stop at; 0.0 runs
            to the bitwise fixpoint.
        mesh: split the time axis over this mesh's ranks (every rank
            passes the same feats, generator seed and noise).

    Returns: the `Sampler.sample` result dict, plus
        result['picard'] = {'sweeps': int, 'deltas': [per-sweep float]}.
    """
    return picard_sample_prepared(sampler, sampler.prepare(feats, generator),
                                  generator, noise, max_sweeps, tol, mesh)


@torch.no_grad()
def picard_sample_prepared(sampler, batch: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[Dict[str, torch.Tensor]] = None,
                           max_sweeps: Optional[int] = None, tol: float = 0.0,
                           mesh: Optional[mesh_lib.Mesh] = None
                           ) -> Dict[str, Any]:
    """`picard_sample` from a prepared batch (as `Sampler.prepare` returns
    it, or the JAX package's `Sampler.prepare` output), as
    `Sampler.sample_prepared` is `Sampler.sample`'s."""
    c = sampler.config
    traj, state0 = sampler._start(batch)
    grids = sampler.step_grids()
    ts = grids[0]
    n = len(ts)
    b, l = state0['seq_t'].shape
    dev = state0['seq_t'].device
    num_states = sampler.diffuser.seq.num_states
    k_corr = (c.seq_corrector_steps
              if sampler.diffuser.config.diffuse_seq else 0)
    if noise is None:
        if generator is None:
            raise ValueError('picard: give the per-step noise or a generator')
        noise = draw_noise(generator, n, b, l, num_states, device=dev)
    noise = dict(noise)
    for k, v in noise.items():
        if v.shape[0] != n:
            raise ValueError(
                f'noise[{k!r}] leading dim {v.shape[0]} != grid length {n} '
                '(num_t + 1 with the self-conditioning prime step)')
    if k_corr and 'corr_u' not in noise:
        fixed = torch.Generator(device=dev).manual_seed(0)
        noise['corr_u'] = torch.rand((n, k_corr, b, l, num_states),
                                     generator=fixed, device=dev)
    if sampler.esm_reuse and c.esm_refresh_every > 1:
        # Never read: position 0 always refreshes; the others' inputs are
        # outputs of earlier positions after the first sweep.
        d = sampler.esm_fn.config.embed_dim
        state0['esm_cache'] = torch.zeros((b, sampler.model.antibody_len, d),
                                          device=dev)

    # This rank's grid positions: the time axis padded to a multiple of the
    # mesh size with copies of the last position, split in blocks.
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    n_pad = n + (-n) % size
    per = n_pad // size
    pos = np.minimum(np.arange(rank * per, (rank + 1) * per), n - 1)
    rows = np.repeat(pos, b)
    p = len(pos)
    my_traj = type(traj)(
        {k: _tile(v, p) if torch.is_tensor(v) and v.dim() and
         v.shape[0] == b else v for k, v in traj.static.items()},
        {k: _tile(v, p) for k, v in traj.static_acts.items()},
        _tile(traj.diffuse_mask, p))

    idx = torch.as_tensor(pos, device=dev)

    def per_row(k, x):  # (grid, [k,] B, ...) -> this rank's rows
        x = x.to(dev)[idx]
        if k == 'corr_u':  # (p, k, B, ...) -> (k, p * B, ...)
            return x.transpose(0, 1).reshape((k_corr, p * b) + x.shape[3:])
        return x.reshape((p * b,) + x.shape[2:])
    my_noise = {k: per_row(k, v) for k, v in noise.items()}

    def gather(x):
        return mesh_lib.all_gather_rows(mesh, x) if mesh is not None else x

    # Initial guess: every position's input state is s_0.
    states_in = {k: _tile(v, n) for k, v in state0.items()}
    budget = max_sweeps if max_sweeps is not None else n + 1
    deltas = []
    for _ in range(budget):
        mine = {k: _rows(v, pos, b) for k, v in states_in.items()}
        out_state, outs = sampler.step(my_traj, mine, rows, None, my_noise)
        states_out = {k: gather(v)[:n * b] for k, v in out_state.items()}
        # Next guess: position 0 keeps s_0, position i + 1 gets step i's
        # output.
        shifted = {k: torch.cat([state0[k], states_out[k][:(n - 1) * b]])
                   for k in states_in}
        deltas.append(_max_abs_delta(shifted, states_in))
        states_in = shifted
        if deltas[-1] <= tol:
            break

    outs = {k: gather(v)[:n * b] for k, v in outs.items()}
    steps = [s for s in range(n) if not grids[2][s]]
    step_out = [{**{k: v[s * b:(s + 1) * b] for k, v in outs.items()},
                 't': float(ts[s])} for s in steps]
    last = step_out[-1]
    result = {
        'rigids': states_out['rigids_t'][(n - 1) * b:],
        'seq': last['seq'], 'atom14': last['atom14'],
        'plddt': last['plddt'], 'diffuse_mask': traj.diffuse_mask,
        'gt_atom14': traj.static['atom14_gt_positions'],
        'picard': {'sweeps': len(deltas), 'deltas': deltas},
    }
    if c.collect_trajectory:
        result['trajectory'] = step_out
    return result
