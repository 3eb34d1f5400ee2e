"""Training loop, on one device or data-parallel over processes.

Counterpart of abx_tpu/train/trainer.py: the same `TrainConfig`, the same
optimizer (global-norm clipping, then AdamW with its weight decay scaled by
the scheduled learning rate, the schedule a linear warmup from 0 with an
optional cosine decay), the same EMA of the weights after each update, the
same per-step recycle depth drawn from 0..num_recycle, the same losses
(`train/losses.py`) and the same three checkpoint files.  The optimizer is
written out as optax computes it (the first update at schedule(0), the
clip without an epsilon), so a step moves the weights as the JAX trainer's
does.

The model trains in train() mode: dropout drawn from the step's
`torch.Generator`, two-pass LayerNorms, and no kernel route (the kernels
have no backward).  A frozen ESM2 (`esm`) runs inside every trunk pass as
in the JAX trainer; its layers run without grad, so its attention kernel
launches on the card, and only the learned layer weights take gradient.

The step is split so that a test can feed an already-noised batch and a
fixed recycle count: `prepare_batch` (the train-mode features),
`draw_recycles`, `loss_and_grads` and `apply_update`.

Data parallelism (a `mesh` of several ranks, parallel/mesh.py, one device
each): a rank is given its rows of the global batch, and its step is the
one-process step on the whole batch.  It gathers the rows, draws the
noise and the recycle depth for the whole batch from the step's generator
(seeded alike on every rank) and keeps its rows, draws the dropout masks
for the whole batch and keeps its rows (`modules.RowShard`), computes the
global-batch loss (`train/losses.py` sums each reduction's numerator and
denominator over the ranks) and its rows' share of the gradient, sums the
gradients over the ranks with one all_reduce, and applies the same update
on every rank.  Rank 0 writes the checkpoints and the metrics.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from abx_tpu_torch.data.features import (FeatureBuilder,
                                         make_diffuser_features,
                                         make_static_pair_features)
from abx_tpu_torch.models.modules import RowShard
from abx_tpu_torch.models.network import forward_with_recycling, zero_prev
from abx_tpu_torch.parallel import mesh as mesh_lib
from abx_tpu_torch.sampling.sampler import to_device_batch
from abx_tpu_torch.train.losses import total_loss
from abx_tpu_torch.utils import checkpoint as ckpt_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 1000
    # >0 enables cosine decay from peak LR to min_lr_ratio*peak over
    # `decay_steps` steps after warmup; 0 keeps warmup-then-constant.
    decay_steps: int = 0
    min_lr_ratio: float = 0.1
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    generate_area: str = 'cdr'
    log_every: int = 50  # <=0 disables periodic logging/metrics rows
    checkpoint_every: int = 1000
    ema_decay: float = 0.999  # 0 disables EMA


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax's `linear_schedule(0, lr, warmup_steps)`, or with
    `decay_steps` its `warmup_cosine_decay_schedule` ending at
    min_lr_ratio * lr, at update number `count` (0 for the first), in
    float32 as optax computes it."""
    f32 = np.float32
    lr, warm = cfg.learning_rate, cfg.warmup_steps
    if count < warm or cfg.decay_steps <= 0:
        if warm <= 0:        # optax holds a non-positive ramp at its start
            return 0.0
        c = min(max(count, 0), warm)
        frac = f32(1) - f32(c) / f32(warm)
        return float(f32(0.0 - lr) * frac + f32(lr))
    alpha = f32(cfg.min_lr_ratio * lr / lr)
    c = f32(min(count - warm, cfg.decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                         / f32(cfg.decay_steps)))
    return float(f32(lr) * ((f32(1) - alpha) * cosine + alpha))


@dataclasses.dataclass
class TrainState:
    """What a resume needs besides the weights, which live in the model:
    the number of updates made, Adam's moments and the EMA weights (None
    when `ema_decay` is 0), each by parameter name."""
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Trainer:
    def __init__(self, model, diffuser, model_config, loss_config,
                 train_config: TrainConfig = TrainConfig(), esm=None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        """`model` a ScoreNetworkIteration (f32); `esm` the frozen
        AntibodyESM when the trunk is ESM-conditioned; `mesh` the
        data-parallel ranks (default: this process alone)."""
        self.model = model
        self.diffuser = diffuser
        self.model_config = model_config
        self.loss_config = loss_config
        self.config = train_config
        self.esm = esm
        self.feature_builder = FeatureBuilder(is_training=True)
        self.device = next(model.parameters()).device
        self.mesh = mesh or mesh_lib.local_mesh(self.device)
        self._checked = False

    def _params(self) -> Dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.model.named_parameters()
                if p.requires_grad}

    def init_state(self) -> TrainState:
        params = self._params()
        ema = None
        if self.config.ema_decay > 0:
            ema = {k: p.detach().clone() for k, p in params.items()}
        return TrainState(
            step=0, mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()}, ema=ema)

    # --- one step, in parts ------------------------------------------------

    def prepare_batch(self, batch: Dict, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
        """Stacked numpy (or tensor) batch -> the noised training batch on
        the device: the feature pipeline, the train-mode diffuser features
        (t ~ U[0.01, 1), the jittered CDR subset), the static pair
        features and zero recycling features."""
        b = self.feature_builder(to_device_batch(batch, self.device))
        b = make_diffuser_features(
            b, diffuser=self.diffuser, generate_area=self.config.generate_area,
            generator=generator, mode='train', is_training=True)
        b = make_static_pair_features(b)
        n, l = b['seq'].shape
        b.update(zero_prev(n, l, self.model_config, dtype=self.model.dtype,
                           device=self.device))
        return b

    def draw_recycles(self, generator: torch.Generator) -> int:
        """This step's recycle depth, uniform over 0..num_recycle."""
        return int(torch.randint(0, self.model_config.num_recycle + 1, (1,),
                                 generator=generator,
                                 device=self.device).item())

    def loss_and_grads(self, batch: Dict, num_recycle: int,
                       generator: Optional[torch.Generator]) -> Dict:
        """Forward in train() mode with `num_recycle` no-grad recycle passes
        and the final pass with grad, the losses, and their gradients in
        the parameters' `.grad`.  Returns the metrics (tensors)."""
        model = self.model
        model.train()
        if self.esm is not None:
            self.esm.train()
        for p in model.parameters():
            p.grad = None
        static = model.static_embeddings(batch)

        def single(mb, compute_loss):
            return model(mb, static_acts=static, esm_fn=self.esm,
                         compute_loss=compute_loss, generator=generator)

        outputs = forward_with_recycling(
            single, batch, num_recycle,
            self.model_config.embeddings_and_seqformer.prev_pos,
            compute_loss=True)
        out = total_loss(batch, outputs, self.loss_config,
                         model.antibody_len,
                         self.mesh.group if self.mesh.size > 1 else None)
        out['loss'].backward()
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in out['metrics'].items()}
        metrics['num_recycle'] = num_recycle
        return metrics

    @torch.no_grad()
    def apply_update(self, state: TrainState) -> torch.Tensor:
        """Clip the gradients to `grad_clip` in global norm, take one AdamW
        step at the scheduled learning rate, update the EMA; returns the
        global norm before clipping."""
        cfg = self.config
        params = self._params()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        g_norm = global_norm(grads.values())
        if not bool(g_norm < cfg.grad_clip):
            grads = {k: g / g_norm * cfg.grad_clip for k, g in grads.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = state.step + 1
        # The bias corrections in float32, as optax forms them.
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                    for b in (b1, b2))
        lr = learning_rate(cfg, state.step)
        for k, p in params.items():
            g = grads[k]
            mu = (1 - b1) * g + b1 * state.mu[k]
            nu = (1 - b2) * torch.square(g) + b2 * state.nu[k]
            state.mu[k], state.nu[k] = mu, nu
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            update = update + cfg.weight_decay * p
            p.add_(-lr * update)
        state.step = count
        if state.ema is not None:
            d = cfg.ema_decay
            for k, p in params.items():
                state.ema[k] = d * state.ema[k] + (1.0 - d) * p
        return g_norm

    def step(self, state: TrainState, batch: Dict,
             generator: torch.Generator) -> Dict:
        """One training step on a stacked batch: noise it, draw the recycle
        depth, forward and backward, update.  With a mesh of several ranks
        `batch` is this rank's rows of the global batch (see the module
        note).  Returns the metrics (the losses, `grad_norm` before
        clipping, `num_recycle`)."""
        mesh = self.mesh
        if mesh.size == 1:
            b = self.prepare_batch(batch, generator)
            n_rec = self.draw_recycles(generator)
            metrics = self.loss_and_grads(b, n_rec, generator)
        else:
            local = to_device_batch(batch, self.device)
            b = self.prepare_batch(
                {k: mesh_lib.all_gather_rows(mesh, v)
                 for k, v in local.items()}, generator)
            n_rec = self.draw_recycles(generator)
            n = b['seq'].shape[0]
            rows = mesh_lib.batch_sharding(mesh).rows(n, mesh.rank)
            mine = mesh_lib.shard_batch(mesh, b)
            if not self._checked:  # once a run
                mesh_lib.check_shards(mesh, b, mine)
                if not mesh_lib.all_ranks_agree(
                        mesh, mesh_lib.min_over_ranks(mesh, n_rec) == n_rec):
                    raise RuntimeError('the ranks drew different recycle '
                                       'depths')
                self._checked = True
            metrics = self.loss_and_grads(
                mine, n_rec, RowShard(generator, rows.start, rows.stop, n))
            self._sum_grads()
        metrics['grad_norm'] = self.apply_update(state)
        return metrics

    def _sum_grads(self) -> None:
        """Sum the gradients over the mesh's ranks (one all_reduce of
        every gradient, flattened)."""
        params = list(self._params().values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    # --- the loop ----------------------------------------------------------

    def fit(self, state: TrainState, data_iter: Iterator, num_steps: int,
            generator: torch.Generator,
            checkpoint_path: Optional[str] = None,
            metrics_path: Optional[str] = None) -> TrainState:
        """`num_steps` steps; one CSV row per `log_every` steps appended to
        `metrics_path` (under an existing header), the step axis continuing
        from `state.step`; checkpoints every `checkpoint_every` steps and at
        the end."""
        cfg = self.config
        t0 = time.time()
        metrics_writer = metrics_file = None
        start_step = state.step
        try:
            for i in range(num_steps):
                batch = next(data_iter)
                metrics = self.step(state, batch, generator)
                gstep = start_step + i + 1
                if cfg.log_every > 0 and (i + 1) % cfg.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    rate = cfg.log_every / (time.time() - t0)
                    t0 = time.time()
                    logger.info('step %d: loss=%.4f aar=%.3f (%.2f steps/s)',
                                gstep, metrics['total'],
                                metrics.get('seq/aar', -1), rate)
                    if metrics_path and self.mesh.rank == 0:
                        row = dict(step=gstep, steps_per_sec=rate, **metrics)
                        if metrics_writer is None:
                            metrics_writer, metrics_file = \
                                self._open_metrics(metrics_path, row)
                        metrics_writer.writerow(row)
                        metrics_file.flush()
                if (checkpoint_path and cfg.checkpoint_every > 0
                        and (i + 1) % cfg.checkpoint_every == 0):
                    self.save(checkpoint_path, state)
        finally:
            if metrics_file is not None:
                metrics_file.close()
            # Stop a prefetching iterator now: its producer would go on
            # building (and moving to the device) batches until collected.
            close = getattr(data_iter, 'close', None)
            if callable(close):
                close()
        if checkpoint_path:
            self.save(checkpoint_path, state)
        return state

    @staticmethod
    def _open_metrics(metrics_path: str, row: Dict):
        """Open the metrics CSV for append, reusing an existing header (its
        columns rule: extra metrics are dropped, absent ones left blank)."""
        fieldnames = sorted(row)
        exists = os.path.exists(metrics_path) and \
            os.path.getsize(metrics_path) > 0
        if exists:
            with open(metrics_path, newline='', encoding='utf-8') as f:
                existing = next(csv.reader(f), None)
            if existing:
                dropped = sorted(set(fieldnames) - set(existing))
                if dropped:
                    logger.warning(
                        'metrics.csv: appending under the existing header; '
                        'dropping columns not in it: %s', dropped)
                fieldnames = existing
        metrics_file = open(metrics_path, 'a', newline='', encoding='utf-8')
        writer = csv.DictWriter(metrics_file, fieldnames=fieldnames,
                                restval='', extrasaction='ignore')
        if not exists:
            writer.writeheader()
        return writer, metrics_file

    # --- checkpoints -------------------------------------------------------

    def save(self, checkpoint_path: str, state: TrainState) -> None:
        """Three files, each written atomically: the inference weights (the
        EMA when kept) at `checkpoint_path`, the raw weights at `.raw`, and
        the whole training state at `.train`.  Only rank 0 writes (every
        rank holds the same state)."""
        if self.mesh.rank:
            return
        raw = {k: p.detach() for k, p in self._params().items()}
        ckpt_lib.save_params(checkpoint_path, self._weights(
            state.ema if state.ema is not None else raw))
        ckpt_lib.save_params(checkpoint_path + '.raw', self._weights(raw))
        ckpt_lib.save_params(checkpoint_path + '.train', {
            'step': state.step, 'params': raw, 'mu': state.mu,
            'nu': state.nu, 'ema': state.ema})

    def _weights(self, params: Dict[str, torch.Tensor]):
        """A full state dict of the model with `params` in place of its
        trainable parameters."""
        out = {k: v.detach() for k, v in self.model.state_dict().items()}
        out.update(params)
        return out

    def load_train_state(self, checkpoint_path: str) -> TrainState:
        """Restore what `save` wrote at `<checkpoint_path>.train`: the raw
        weights into the model, and the step, the moments and the EMA."""
        path = checkpoint_path + '.train'
        saved = ckpt_lib.load_params(path, map_location=self.device)
        params = self._params()
        names: List[str] = sorted(params)
        if sorted(saved['params']) != names:
            raise ValueError(f'{path}: its parameters are not the model\'s')
        with torch.no_grad():
            for k in names:
                params[k].copy_(saved['params'][k])
        return TrainState(step=int(saved['step']), mu=saved['mu'],
                          nu=saved['nu'], ema=saved['ema'])
