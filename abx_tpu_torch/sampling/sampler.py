"""Reverse-diffusion sampler: design, optimize and trajectory modes.

Counterpart of abx_tpu/sampling/sampler.py: the same step grid (with the
reference's final-step `t_model` quirk and the self-conditioning prime
step), the same per-step update, and the same injectable per-step `noise`.
Modes:
  * design     -- start from the t=1 reference distribution;
  * optimize   -- re-noise the input complex to t = opt_step / num_t with
                  the forward marginal, then denoise over the steps of the
                  design grid with t <= opt_step / num_t;
  * trajectory -- design, with every step's outputs kept (the runner sets
                  `collect_trajectory`).
The JAX package scans the steps inside one jitted program; here the loop
is a Python loop over device work.  The trajectory-invariant embeddings are
computed once per trajectory.  `sample_resumable` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from abx_tpu_torch.data.features import (FeatureBuilder, make_diffuser_features,
                                         make_static_pair_features)
from abx_tpu_torch.models.network import (forward_with_recycling, get_prev,
                                          zero_prev)


MIN_T = 0.01  # the last reverse step's time


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_t: int = 100
    generate_area: str = 'H3'
    mode: str = 'design'            # design | optimize | trajectory
    opt_step: Optional[int] = None  # optimize mode: re-noise to opt_step/num_t
    # Keep every step's outputs (the shared-noise parity harness compares
    # them step by step); otherwise only the last step's are kept.
    collect_trajectory: bool = False


def to_device_batch(feats: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy feature dict -> tensors on `device` (floats as f32, ints as
    int64); non-array entries are dropped."""
    out = {}
    for k, v in feats.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
            continue
        if isinstance(v, tuple):  # e.g. a Rigid from the JAX pipeline
            continue
        a = np.asarray(v)
        if a.dtype.kind == 'f':
            out[k] = torch.tensor(a, dtype=torch.float32, device=device)
        elif a.dtype.kind in 'iub':
            out[k] = torch.tensor(a.astype(np.int64), device=device)
    return out


class Sampler:
    """Design-mode sampler over a `ScoreNetworkIteration`."""

    def __init__(self, model, diffuser, model_config,
                 sampler_config: SamplerConfig, esm_fn=None):
        """`esm_fn` (an `AntibodyESM`) conditions the trunk when
        `esm.enabled`: it runs inside every trunk pass, on that pass's
        recycled noisy sequence, as in the JAX package and the
        reference."""
        self.model = model
        self.esm_fn = esm_fn
        self.diffuser = diffuser
        self.model_config = model_config
        self.config = c = sampler_config
        if c.mode not in ('design', 'optimize', 'trajectory'):
            raise ValueError(f'SamplerConfig.mode {c.mode!r}')
        steps = np.linspace(MIN_T, 1.0, c.num_t)[::-1].copy()
        if c.mode == 'optimize':
            if c.opt_step is None:
                raise ValueError('optimize mode needs opt_step')
            steps = steps[steps <= c.opt_step / c.num_t + 1e-8]
            if not len(steps):
                raise ValueError(f'optimize: no step of the num_t '
                                 f'{c.num_t} grid has t <= opt_step / num_t '
                                 f'= {c.opt_step / c.num_t}')
        t_model = steps.copy()
        # Parity: at the final step (t <= MIN_T) the reference skips
        # _set_t_feats, so the model sees the previous step's t.
        if len(steps) > 1 and steps[-1] <= MIN_T + 1e-8:
            t_model[-1] = steps[-2]
        self.reverse_steps = steps.astype(np.float32)
        self.model_steps = t_model.astype(np.float32)
        self.dt = float(np.float32(1.0 / c.num_t))

    def step_grids(self):
        """(ts, ts_model): the reverse grid with the self-conditioning
        prime step as a leading extra step (index 0)."""
        ts, tm = self.reverse_steps, self.model_steps
        return np.concatenate([ts[:1], ts]), np.concatenate([tm[:1], tm])

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
        step), keys as in `JointDiffuser.reverse`.  Without it, draws come
        from `generator`."""
        c = self.config
        cfg = self.model_config
        model, diffuser = self.model, self.diffuser
        prev_pos_cfg = cfg.embeddings_and_seqformer.prev_pos
        b, l = batch['seq'].shape
        dev = batch['seq'].device
        dtype = model.dtype

        diffuse_mask = ((1 - batch['fixed_mask'].float())
                        * batch['atom14_gt_exists'][..., 0].float())
        state = {'rigids_t': batch['rigids_t'].float(),
                 'seq_t': batch['seq_t'].long(),
                 **zero_prev(b, l, cfg, dtype=dtype, device=dev)}
        static = {k: v for k, v in batch.items()
                  if k not in ('rigids_t', 'seq_t', 't', 'rot_score_scaling',
                               'trans_score_scaling')}
        static_acts = model.static_embeddings(
            {**static, 'seq_t': state['seq_t']})

        def single(mb):
            return model(mb, static_acts=static_acts, esm_fn=self.esm_fn)

        ts, ts_model = self.step_grids()
        steps_out = []
        for s in range(len(ts)):
            t, prime = float(ts[s]), s == 0
            mb = dict(static)
            mb.update(state)
            t_vec = torch.full((b,), float(ts_model[s]), device=dev)
            rot_s, trans_s = diffuser.score_scaling(t_vec)
            mb.update(t=t_vec, rot_score_scaling=rot_s,
                      trans_score_scaling=trans_s)
            out = forward_with_recycling(single, mb, cfg.num_recycle,
                                         prev_pos_cfg)
            folding = out['heads']['folding']
            seq_head = out['heads']['sequence_module']
            # The reverse transition reads the recycled sequence (the
            # reference mutates seq_t in place during recycling).
            seq_cur = out['recycled_seq_t']
            prev = get_prev(mb, out, prev_pos_cfg)
            step_noise = ({k: v[s] for k, v in noise.items()}
                          if noise else None)
            rigids_rev, seq_rev = diffuser.reverse(
                generator, state['rigids_t'], seq_cur, folding['rot_score'],
                folding['trans_score'], seq_head['logits'],
                torch.full((b,), t, device=dev), self.dt,
                diffuse_mask=diffuse_mask, noise=step_noise)
            if prime:  # prime step: rigids unchanged, seq_t recycled
                rigids_next, seq_next = state['rigids_t'], seq_cur
            elif t <= MIN_T + 1e-8:  # final step: the denoised output
                rigids_next, seq_next = folding['rigids'], seq_head['seq_0']
            else:
                rigids_next, seq_next = rigids_rev, seq_rev
            state = {'rigids_t': rigids_next, 'seq_t': seq_next.long(),
                     **prev}
            if prime or not (c.collect_trajectory or s == len(ts) - 1):
                continue
            plddt = out['heads']['predicted_lddt']['pLDDT']
            steps_out.append({
                'atom14': folding['final_atom14_positions'],
                'seq': seq_next.clamp(0, 19),
                'plddt': torch.sum(plddt * diffuse_mask, dim=1)
                / (torch.sum(diffuse_mask, dim=1) + 1e-8),
                't': t,
            })
        last = steps_out[-1]
        result = {
            'rigids': state['rigids_t'], 'seq': last['seq'],
            'atom14': last['atom14'], 'plddt': last['plddt'],
            'diffuse_mask': diffuse_mask,
            'gt_atom14': batch['atom14_gt_positions'],
        }
        if c.collect_trajectory:
            result['trajectory'] = steps_out
        return result
