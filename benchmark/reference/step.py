"""The reference's entry: one reverse step of the design sampler, from a
given state, in float32.

`Reference.prepare` rebuilds the features and the t = 1 start of a
trajectory from the benchmark's input arrays and a generator;
`Reference.step` runs the step at a grid position from a state: the
recycling passes (ESM2 in each when the configuration has it), the heads,
and the joint reverse update on SO(3), R^3 and the amino-acid track,
with its random draws replayed from a saved generator state.  The batch's
rows are independent, so the passes run in blocks of rows; the reverse
update runs on the whole batch, so that it draws what the program drew.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.esm import AntibodyESM
from benchmark.reference.features import (FeatureBuilder,
                                          make_diffuser_features,
                                          make_static_pair_features)
from benchmark.reference.joint import JointConfig, JointDiffuser
from benchmark.reference.network import (ScoreNetworkIteration,
                                         forward_with_recycling)

# The keys of a prepared batch that evolve over a trajectory.
EVOLVING = ('rigids_t', 'seq_t', 't', 'rot_score_scaling',
            'trans_score_scaling')


class Cfg(dict):
    """A JSON object with attribute access."""

    def __init__(self, d):
        super().__init__({k: Cfg(v) if isinstance(v, dict) else v
                          for k, v in d.items()})

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def load_config(path: str) -> Cfg:
    with open(path, 'r', encoding='utf-8') as f:
        return Cfg(json.load(f))


def step_grid(num_t: int, min_t: float = 0.01):
    """(ts, ts_model, dt): the reverse grid with the self-conditioning
    prime step at index 0, the times the model reads (at the final step
    the previous step's time, as the AbX reference sampler has it), and
    the step size."""
    steps = np.linspace(min_t, 1.0, num_t)[::-1].copy()
    t_model = steps.copy()
    if len(steps) > 1 and steps[-1] <= min_t + 1e-8:
        t_model[-1] = steps[-2]
    ts = np.concatenate([steps[:1], steps]).astype(np.float32)
    tm = np.concatenate([t_model[:1], t_model]).astype(np.float32)
    return ts, tm, float(np.float32(1.0 / num_t))


def _rows(d: Dict, b: int, sl: slice) -> Dict:
    return {k: (v[sl] if torch.is_tensor(v) and v.dim() and v.shape[0] == b
                else v) for k, v in d.items()}


class Reference:
    """The reference model of one configuration file, on `device`.  It is
    built without storage; `load` gives it its weights."""

    def __init__(self, config_path: str, device, rows: int = 4):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg = load_config(config_path)
        self.device = torch.device(device)
        self.rows = rows
        self.diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser),
                                      device=self.device)
        ab_len = cfg.data.max_antibody_len
        with torch.device('meta'):
            self.model = ScoreNetworkIteration(cfg.model, self.diffuser,
                                               ab_len).eval()
        self.esm = None
        es = cfg.model.embeddings_and_seqformer.esm
        if es.enabled:
            with torch.device('meta'):
                self.esm = AntibodyESM(es.num_layers, es.embed_channel,
                                       es.num_heads, ab_len,
                                       es.esm_embed.sep_pad_num).eval()

    def trunk_spec(self):
        """(name, shape) of the trunk's parameters, the port's names."""
        return [(k, tuple(v.shape)) for k, v in
                self.model.state_dict().items()]

    def esm_spec(self):
        """(name, shape) of the ESM2 encoder's parameters (fair-esm's
        names), or [] without ESM2."""
        if self.esm is None:
            return []
        return [(k, tuple(v.shape)) for k, v in
                self.esm.module.state_dict().items()]

    def load(self, trunk: Dict, esm: Optional[Dict] = None) -> None:
        """The weights: `trunk` by the port's parameter names (cast to
        float32), `esm` by fair-esm's (kept in their type; each product
        casts to float32)."""
        self.model.load_state_dict(
            {k: v.to(self.device, torch.float32) for k, v in trunk.items()},
            strict=True, assign=True)
        if self.esm is not None:
            self.esm.module.load_state_dict(
                {k: v.to(self.device) for k, v in esm.items()},
                strict=True, assign=True)
        for p in self.model.parameters():
            p.requires_grad_(False)
        if self.esm is not None:
            for p in self.esm.parameters():
                p.requires_grad_(False)

    @torch.no_grad()
    def prepare(self, feats: Dict[str, torch.Tensor], generator,
                generate_area: str) -> Dict[str, torch.Tensor]:
        """Features and the t = 1 start of a design trajectory."""
        batch = FeatureBuilder()(feats)
        batch = make_diffuser_features(batch, diffuser=self.diffuser,
                                       generate_area=generate_area,
                                       generator=generator, mode='design')
        return make_static_pair_features(batch)

    @staticmethod
    def diffuse_mask(prepared) -> torch.Tensor:
        return ((1 - prepared['fixed_mask'].float())
                * prepared['atom14_gt_exists'][..., 0].float())

    @torch.no_grad()
    def step(self, prepared: Dict[str, torch.Tensor],
             state: Dict[str, torch.Tensor], position: int, num_t: int,
             generator_state: torch.Tensor,
             forced: Optional[List[Optional[Dict]]] = None) -> Dict:
        """The step at grid `position` (not the prime step, 0) from `state`
        (rigids_t, seq_t, prev_pos, prev_seq, prev_pair).  `forced[p]`
        gives pass p's recycled sequence and binned positions.  Returns
        the final pass's logits, predicted frames and scores, the first
        pass's ESM2 embedding (None without ESM2) and the next rigids and
        sequence."""
        cfg = self.cfg.model
        static = {k: v for k, v in prepared.items() if k not in EVOLVING}
        _, tm, _ = step_grid(num_t)
        b = state['seq_t'].shape[0]
        t_model = torch.full((b,), float(tm[position]), device=self.device)
        parts = []
        for r0 in range(0, b, self.rows):
            sl = slice(r0, min(b, r0 + self.rows))
            mb = _rows(static, b, sl)
            acts = self.model.static_embeddings(
                {**mb, 'seq_t': state['seq_t'][sl]})
            mb.update(rigids_t=state['rigids_t'][sl].float(),
                      seq_t=state['seq_t'][sl].long(),
                      prev_pos=state['prev_pos'][sl].long(),
                      prev_seq=state['prev_seq'][sl].float(),
                      prev_pair=state['prev_pair'][sl].float(),
                      t=t_model[sl])
            forced_rows = [None if f is None else
                           {k: v[sl].long() for k, v in f.items()}
                           for f in (forced or [])]
            esm_out = []
            out = forward_with_recycling(
                self.model, mb, acts, cfg.num_recycle,
                cfg.embeddings_and_seqformer.prev_pos, esm_fn=self.esm,
                forced=forced_rows, esm_out=esm_out)
            parts.append({
                'logits': out['sequence']['logits'],
                'frames': out['folding']['rigids'],
                'rot_score': out['folding']['rot_score'],
                'trans_score': out['folding']['trans_score'],
                'recycled_seq_t': out['recycled_seq_t'],
                'esm': esm_out[0] if esm_out else None,
            })
            del out, mb, acts
        res = {k: (None if parts[0][k] is None
                   else torch.cat([p[k] for p in parts]))
               for k in parts[0]}
        rigids, seq = self.update(prepared, state['rigids_t'],
                                  res['recycled_seq_t'], res['rot_score'],
                                  res['trans_score'], res['logits'],
                                  position, num_t, generator_state)
        res.update(rigids_next=rigids, seq_next=seq)
        return res

    @torch.no_grad()
    def scores(self, rigids_t, frames, position: int, num_t: int):
        """The rotation and translation scores of predicted `frames` from
        the noisy `rigids_t` at the time the model reads at `position`."""
        _, tm, _ = step_grid(num_t)
        t = torch.full((rigids_t.shape[0],), float(tm[position]),
                       device=self.device)
        rigids_t, frames = rigids_t.float(), frames.float()
        return (self.diffuser.calc_quat_score(rigids_t[..., :4],
                                              frames[..., :4], t),
                self.diffuser.calc_trans_score(rigids_t[..., 4:],
                                               frames[..., 4:], t))

    @torch.no_grad()
    def update(self, prepared, rigids_t, seq_t, rot_score, trans_score,
               logits, position: int, num_t: int, generator_state):
        """The joint reverse update of an ordinary step at grid `position`
        from the given model outputs, its draws replayed from
        `generator_state`: (next rigids, next sequence)."""
        ts, _, dt = step_grid(num_t)
        b = seq_t.shape[0]
        t = torch.full((b,), float(ts[position]), device=self.device)
        gen = torch.Generator(device=self.device)
        gen.set_state(generator_state)
        rigids, seq = self.diffuser.reverse(
            gen, rigids_t.float(), seq_t.long(), rot_score.float(),
            trans_score.float(), logits, t, dt,
            diffuse_mask=self.diffuse_mask(prepared), center=True,
            noise_scale=1.0)
        return rigids, seq.long()
