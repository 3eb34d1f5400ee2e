"""Reverse-diffusion sampler: design, optimize and trajectory modes.

Counterpart of abx_tpu/sampling/sampler.py: the same step grid (with the
reference's final-step `t_model` quirk and the self-conditioning prime
step), the same per-step update, the same injectable per-step `noise`, the
same opt-in, output-changing options (ESM reuse across recycle passes and
across steps, the sequence Gibbs corrector) and `sample_resumable`.
Modes:
  * design     -- start from the t=1 reference distribution;
  * optimize   -- re-noise the input complex to t = opt_step / num_t with
                  the forward marginal, then denoise over the steps of the
                  design grid with t <= opt_step / num_t;
  * trajectory -- design, with every step's outputs kept (the runner sets
                  `collect_trajectory`).
The JAX package scans the steps inside one jitted program; here the loop
is a Python loop over device work, and the JAX program's `lax.cond` on the
ESM refresh grid is a host-side `if`.  The trajectory-invariant embeddings
are computed once per trajectory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from abx_tpu_torch.data.features import (FeatureBuilder, make_diffuser_features,
                                         make_static_pair_features)
from abx_tpu_torch.models.network import (forward_with_recycling, get_prev,
                                          zero_prev)
from abx_tpu_torch.utils.prof import annotate, annotated


def _save_npz(path: str, arrays: Dict) -> None:
    """Atomic npz save of tensors or arrays that round-trips bfloat16
    (numpy has no bf16): a bf16 tensor is stored as its uint16 view plus a
    `__bf16__<key>` marker, the JAX package's state-file layout."""
    out = {}
    for k, v in arrays.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[k] = v.view(torch.int16).numpy().view(np.uint16)
                out['__bf16__' + k] = np.asarray(1)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    tmp = path + '.tmp.npz'
    np.savez(tmp, **out)
    os.replace(tmp, path)


def _load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Inverse of `_save_npz`: CPU tensors, bf16 restored from its uint16
    views."""
    out = {}
    with np.load(path, allow_pickle=False) as saved:
        for k in saved.files:
            if k.startswith('__bf16__'):
                continue
            v = saved[k]
            if '__bf16__' + k in saved.files:
                out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.array(v))
    return out


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_t: int = 100
    min_t: float = 0.01             # the last reverse step's time
    noise_scale: float = 1.0        # scales the rotation / translation normals
    center: bool = True             # re-centre the translations each step
    self_conditioning: bool = True  # the prime step at grid index 0
    generate_area: str = 'H3'
    mode: str = 'design'            # design | optimize | trajectory
    opt_step: Optional[int] = None  # optimize mode: re-noise to opt_step/num_t
    # Keep every step's outputs (the shared-noise parity harness compares
    # them step by step); otherwise only the last step's are kept.
    collect_trajectory: bool = False
    # Opt-in, output-changing: one ESM pass per diffusion step, on the
    # step's input seq_t, its weighted embedding shared by the recycle
    # passes (the reference recomputes it in every pass on the recycled
    # sequence).  Needs an esm_fn; ignored without one.
    esm_reuse_recycles: bool = False
    # Opt-in, output-changing, with esm_reuse_recycles: recompute the
    # cached embedding only at every k-th grid position (the prime step is
    # position 0); the steps between launch no ESM work.
    esm_refresh_every: int = 1
    # Opt-in, output-changing: k Gibbs-corrector jumps on the sequence after
    # each predictor step, at t_next = max(t - dt, min_t) with leap
    # dt * corrector_scale, reusing the step's logits.
    seq_corrector_steps: int = 0
    corrector_scale: float = 1.0


def to_device_batch(feats: Dict, device, non_blocking: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """numpy feature dict -> tensors on `device` (floats as f32, ints as
    int64); non-array entries are dropped.  With `non_blocking`, a copy
    to a CUDA device goes from pinned host memory without blocking (the
    training prefetch's producer thread)."""
    dev = torch.device(device)
    pin = non_blocking and dev.type == 'cuda'
    out = {}
    for k, v in feats.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(dev, non_blocking=non_blocking)
            continue
        if isinstance(v, tuple):  # e.g. a Rigid from the JAX pipeline
            continue
        a = np.asarray(v)
        if a.dtype.kind not in 'fiub':
            continue
        h = torch.tensor(a, dtype=(torch.float32 if a.dtype.kind == 'f'
                                   else torch.int64))
        out[k] = (h.pin_memory() if pin else h).to(dev,
                                                  non_blocking=non_blocking)
    return out


@dataclasses.dataclass
class _Trajectory:
    """What stays fixed over one trajectory: the feature dict without the
    evolving state, the hoisted embeddings and the diffused-residue mask."""
    static: Dict[str, torch.Tensor]
    static_acts: Dict[str, torch.Tensor]
    diffuse_mask: torch.Tensor


class Sampler:
    """Design-mode sampler over a `ScoreNetworkIteration`."""

    def __init__(self, model, diffuser, model_config,
                 sampler_config: SamplerConfig, esm_fn=None):
        """`esm_fn` (an `AntibodyESM`) conditions the trunk when
        `esm.enabled`: it runs inside every trunk pass, on that pass's
        recycled noisy sequence, as in the JAX package and the reference,
        or once per refresh step with `esm_reuse_recycles`."""
        self.model = model
        self.esm_fn = esm_fn
        self.diffuser = diffuser
        self.model_config = model_config
        self.config = c = sampler_config
        if c.mode not in ('design', 'optimize', 'trajectory'):
            raise ValueError(f'SamplerConfig.mode {c.mode!r}')
        if c.num_t < 1:
            raise ValueError(f'SamplerConfig.num_t {c.num_t} < 1')
        if c.esm_refresh_every < 1:
            raise ValueError(f'SamplerConfig.esm_refresh_every '
                             f'{c.esm_refresh_every} < 1')
        if c.seq_corrector_steps < 0:
            raise ValueError(f'SamplerConfig.seq_corrector_steps '
                             f'{c.seq_corrector_steps} < 0')
        steps = np.linspace(c.min_t, 1.0, c.num_t)[::-1].copy()
        if c.mode == 'optimize':
            if c.opt_step is None:
                raise ValueError('optimize mode needs opt_step')
            steps = steps[steps <= c.opt_step / c.num_t + 1e-8]
            if not len(steps):
                raise ValueError(f'optimize: no step of the num_t '
                                 f'{c.num_t} grid has t <= opt_step / num_t '
                                 f'= {c.opt_step / c.num_t}')
        t_model = steps.copy()
        # Parity: at the final step (t <= min_t) the reference skips
        # _set_t_feats, so the model sees the previous step's t.
        if len(steps) > 1 and steps[-1] <= c.min_t + 1e-8:
            t_model[-1] = steps[-2]
        self.reverse_steps = steps.astype(np.float32)
        self.model_steps = t_model.astype(np.float32)
        self.dt = float(np.float32(1.0 / c.num_t))
        self.esm_reuse = c.esm_reuse_recycles and esm_fn is not None

    def step_grids(self):
        """(ts, ts_model, is_prime, refresh): the reverse grid, with the
        self-conditioning prime step as a leading extra step (index 0) when
        `self_conditioning`; `refresh` flags the grid positions whose ESM
        embedding is recomputed under esm_reuse_recycles (every
        esm_refresh_every-th, from 0)."""
        ts, tm = self.reverse_steps, self.model_steps
        is_prime = np.zeros(len(ts), bool)
        if self.config.self_conditioning:
            ts = np.concatenate([ts[:1], ts])
            tm = np.concatenate([tm[:1], tm])
            is_prime = np.concatenate([[True], is_prime])
        refresh = np.arange(len(ts)) % self.config.esm_refresh_every == 0
        return ts, tm, is_prime, refresh

    def prepare(self, feats: Dict[str, torch.Tensor],
                generator: torch.Generator) -> Dict:
        """Geometry features + the initial noisy state for the mode (t=1
        in design and trajectory modes, t = opt_step / num_t in optimize
        mode)."""
        c = self.config
        batch = FeatureBuilder()(feats)
        optimize = c.mode == 'optimize'
        batch = make_diffuser_features(
            batch, diffuser=self.diffuser, generate_area=c.generate_area,
            generator=generator, mode='optimize' if optimize else 'design',
            t_value=c.opt_step / c.num_t if optimize else None)
        return make_static_pair_features(batch)

    def sample(self, feats: Dict[str, torch.Tensor],
               generator: torch.Generator,
               noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        return self.sample_prepared(self.prepare(feats, generator),
                                    generator, noise)

    @torch.no_grad()
    def sample_prepared(self, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict:
        """Run the reverse process from a prepared batch (as `prepare`
        returns it, or the JAX package's `Sampler.prepare` output).

        `noise` optionally injects the per-step primitive draws: arrays
        with a leading axis over the step grid (its steps + 1 with the prime
        step), keys as in `JointDiffuser.reverse`, and optionally
        'corr_u' (grid, k, B, L, S) uniforms for the corrector's k jumps
        (`sampling/picard.py::draw_noise` draws them all).  The draws it
        lacks come from `generator`."""
        traj, state = self._start(batch)
        outs: List[Dict] = []
        state = self._run_steps(traj, state, 0, len(self.step_grids()[0]),
                                generator, noise, outs)
        return self._result(traj, state, outs)

    @torch.no_grad()
    def sample_resumable(self, feats: Dict[str, torch.Tensor],
                         generator: torch.Generator, chunk_steps: int = 20,
                         state_path: Optional[str] = None) -> Dict:
        """`sample`, run in chunks of `chunk_steps` grid positions, with the
        sampler state (rigids_t / seq_t / prev_* / the ESM cache when
        esm_refresh_every > 1) and the generator's state saved to
        `state_path` between chunks, so a killed process resumes
        mid-trajectory.  A call that finds `state_path` resumes from it: the
        caller passes the same feats and a generator seeded as for the first
        call (`prepare` re-derives the fixed features; the saved generator
        state then replaces it before any further draw).  The result equals
        `sample`'s with the same generator, bitwise.

        bf16 carries are stored as 16-bit views with a dtype marker.  With
        `collect_trajectory` the finished steps' outputs are kept in
        `<state_path>.traj`, so a resumed run returns the whole trajectory.
        The files are removed at the end."""
        if chunk_steps < 1:
            raise ValueError(f'chunk_steps {chunk_steps} < 1')
        traj, state = self._start(self.prepare(feats, generator))
        n = len(self.step_grids()[0])
        traj_path = state_path + '.traj' if state_path else None
        pos, outs = 0, []
        if state_path and os.path.exists(state_path):
            saved = _load_npz(state_path)
            pos = int(saved.pop('__chunk_pos__'))
            generator.set_state(saved.pop('__generator__'))
            dev = state['seq_t'].device
            state = {k: v.to(dev) for k, v in saved.items()}
            if self.config.collect_trajectory and os.path.exists(traj_path):
                outs = _unstack_steps(_load_npz(traj_path), dev)
        while pos < n:
            end = min(pos + chunk_steps, n)
            state = self._run_steps(traj, state, pos, end, generator, None,
                                    outs)
            pos = end
            if state_path and pos < n:
                if self.config.collect_trajectory:
                    _save_npz(traj_path, _stack_steps(outs))
                _save_npz(state_path, {
                    **state, '__chunk_pos__': np.asarray(pos),
                    '__generator__': generator.get_state()})
        for p in (state_path, traj_path):
            if p and os.path.exists(p):
                os.remove(p)
        return self._result(traj, state, outs)

    # -- the trajectory, step by step ---------------------------------------
    def _start(self, batch):
        """The fixed part of a prepared batch and the initial state."""
        b, l = batch['seq'].shape
        dev = batch['seq'].device
        diffuse_mask = ((1 - batch['fixed_mask'].float())
                        * batch['atom14_gt_exists'][..., 0].float())
        state = {'rigids_t': batch['rigids_t'].float(),
                 'seq_t': batch['seq_t'].long(),
                 **zero_prev(b, l, self.model_config, dtype=self.model.dtype,
                             device=dev)}
        static = {k: v for k, v in batch.items()
                  if k not in ('rigids_t', 'seq_t', 't', 'rot_score_scaling',
                               'trans_score_scaling')}
        static_acts = self.model.static_embeddings(
            {**static, 'seq_t': state['seq_t']})
        return _Trajectory(static, static_acts, diffuse_mask), state

    def _esm_weighted(self, seq_t, static):
        """The weighted ESM embedding of `seq_t`'s antibody part, as the
        trunk's esm_fn call computes it."""
        return self.esm_fn(seq_t[:, :self.model.antibody_len],
                           static['heavy_len'], static['light_len'],
                           self.model.esm_layer_weights())

    def _run_steps(self, traj: _Trajectory, state, start: int, end: int,
                   generator, noise, outs: List[Dict]):
        """Grid positions [start, end); the kept step outputs are appended
        to `outs`.  Returns the state after them."""
        c = self.config
        b = traj.diffuse_mask.shape[0]
        grids = self.step_grids()
        n = len(grids[0])
        for s in range(start, end):
            rows = np.full(b, s)
            step_noise = ({k: v[s] for k, v in noise.items()}
                          if noise else None)
            state, out = self.step(traj, state, rows, generator, step_noise)
            if grids[2][s] or not (c.collect_trajectory or s == n - 1):
                continue
            outs.append({**out, 't': float(grids[0][s])})
        return state

    @annotated('abx.step')
    def step(self, traj: _Trajectory, state, positions: np.ndarray,
             generator, noise: Optional[Dict[str, torch.Tensor]] = None):
        """One reverse step on every row of `state`, row i at grid position
        `positions[i]` (its own t, t_model, prime and ESM-refresh flag):
        the sequential sampler passes one position for all rows, the Picard
        sampler (`sampling/picard.py`) every position at once.  The prime,
        final and ordinary updates are chosen per row; where all rows agree
        only that update is computed, so the sequential sampler's bits and
        draws are those of a step at one position.  `noise` holds this
        step's per-row draws (keys of `JointDiffuser.reverse`, and
        'corr_u' (k, R, L, S) uniforms for the corrector's jumps); the
        draws it lacks come from `generator`.  Returns (next state, the
        step's outputs: atom14, seq, plddt).  Under a profiler the step is
        the span `abx.step`, and its work after the last pass `abx.update`."""
        c = self.config
        cfg = self.model_config
        model, diffuser = self.model, self.diffuser
        prev_pos_cfg = cfg.embeddings_and_seqformer.prev_pos
        static, mask = traj.static, traj.diffuse_mask
        dev = mask.device
        esm_fn = None if self.esm_reuse else self.esm_fn
        ts, ts_model, is_prime, refresh = self.step_grids()
        prime = is_prime[positions]
        last = ts[positions].astype(np.float64) <= c.min_t + 1e-8
        t = torch.from_numpy(ts[positions]).to(dev)
        t_model = torch.from_numpy(ts_model[positions]).to(dev)

        def single(mb, compute_loss=False):
            return model(mb, static_acts=traj.static_acts, esm_fn=esm_fn,
                         compute_loss=compute_loss)

        mb = dict(static)
        mb.update({k: v for k, v in state.items() if k != 'esm_cache'})
        rot_s, trans_s = diffuser.score_scaling(t_model)
        mb.update(t=t_model, rot_score_scaling=rot_s,
                  trans_score_scaling=trans_s)
        esm_w = None
        if self.esm_reuse:
            fresh = refresh[positions]
            esm_w = _pick(fresh, lambda: self._esm_weighted(state['seq_t'],
                                                            static),
                          lambda: state['esm_cache'])
            mb['esm_weighted'] = esm_w
        out = forward_with_recycling(single, mb, cfg.num_recycle,
                                     prev_pos_cfg)
        with annotate('abx.update'):
            folding = out['heads']['folding']
            seq_head = out['heads']['sequence_module']
            # The reverse transition reads the recycled sequence (the
            # reference mutates seq_t in place during recycling).
            seq_cur = out['recycled_seq_t']
            prev = get_prev(mb, out, prev_pos_cfg)
            rigids_rev, seq_rev = diffuser.reverse(
                generator, state['rigids_t'], seq_cur, folding['rot_score'],
                folding['trans_score'], seq_head['logits'], t, self.dt,
                diffuse_mask=mask, center=c.center, noise_scale=c.noise_scale,
                noise=noise)
            ordinary = ~(prime | last)
            if (ordinary.any() and c.seq_corrector_steps
                    and diffuser.config.diffuse_seq):
                seq_rev = self._correct(generator, seq_rev, seq_head['logits'],
                                        ts[positions], mask,
                                        (noise or {}).get('corr_u'))
            # Final step: the denoised output; prime step: rigids unchanged,
            # seq_t recycled (the prime flag wins, as in the JAX program).
            rigids_next = _pick(last, lambda: folding['rigids'],
                                lambda: rigids_rev)
            seq_next = _pick(last, lambda: seq_head['seq_0'], lambda: seq_rev)
            rigids_next = _pick(prime, lambda: state['rigids_t'],
                                lambda: rigids_next)
            seq_next = _pick(prime, lambda: seq_cur, lambda: seq_next)
            new_state = {'rigids_t': rigids_next, 'seq_t': seq_next.long(),
                         **prev}
            if esm_w is not None and c.esm_refresh_every > 1:
                new_state['esm_cache'] = esm_w
            plddt = out['heads']['predicted_lddt']['pLDDT']
            return new_state, {
                'atom14': folding['final_atom14_positions'],
                'seq': seq_next.clamp(0, 19),
                'plddt': torch.sum(plddt * mask, dim=1)
                / (torch.sum(mask, dim=1) + 1e-8),
            }

    def _correct(self, generator, seq, logits, t, mask, u=None):
        """`seq_corrector_steps` Gibbs-corrector jumps at t_next = max(t -
        dt, min_t) (f32 per row, t the rows' grid times, as the JAX program
        takes it), fixed sites mixed back through `mask`; `u` (k, R, L, S)
        injects the jumps' uniforms.  The prime and final steps discard the
        predictor's sequence, so they run none."""
        c = self.config
        t_next = torch.from_numpy(np.maximum(
            t.astype(np.float32) - np.float32(self.dt),
            np.float32(c.min_t))).to(seq.device)
        for i in range(c.seq_corrector_steps):
            seq_c = self.diffuser.seq.corrector(
                generator, seq, logits, t_next, self.dt * c.corrector_scale,
                u=None if u is None else u[i])
            seq = (mask * seq_c + (1 - mask) * seq).long()
        return seq

    def _result(self, traj: _Trajectory, state, outs: List[Dict]) -> Dict:
        last = outs[-1]
        result = {
            'rigids': state['rigids_t'], 'seq': last['seq'],
            'atom14': last['atom14'], 'plddt': last['plddt'],
            'diffuse_mask': traj.diffuse_mask,
            'gt_atom14': traj.static['atom14_gt_positions'],
        }
        if self.config.collect_trajectory:
            result['trajectory'] = outs
        return result


def _pick(flags: np.ndarray, when, otherwise):
    """Per-row choice: `when()` where `flags` (R,) holds, else
    `otherwise()`; only the one needed is computed when all rows agree."""
    if flags.all():
        return when()
    if not flags.any():
        return otherwise()
    a, b = when(), otherwise()
    keep = torch.from_numpy(flags).to(a.device)
    return torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _stack_steps(outs: List[Dict]) -> Dict[str, torch.Tensor]:
    """Kept step outputs -> one tensor per key with a leading step axis."""
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]
               if k != 't'}
    stacked['t'] = torch.tensor([o['t'] for o in outs], dtype=torch.float32)
    return {'steps/' + k: v for k, v in stacked.items()}


def _unstack_steps(saved: Dict[str, torch.Tensor], device) -> List[Dict]:
    """Inverse of `_stack_steps`, onto `device`."""
    steps = {k.split('/', 1)[1]: v for k, v in saved.items()
             if k.startswith('steps/')}
    return [{k: (float(v[i]) if k == 't' else v[i].to(device))
             for k, v in steps.items()}
            for i in range(len(steps['t']))]
