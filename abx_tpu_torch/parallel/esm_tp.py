"""Tensor-parallel frozen ESM2 over a (data, model) process mesh.

Counterpart of abx_tpu/parallel/esm_tp.py.  The frozen ESM2-3B dominates
the ESM-conditioned workload's weights and operations; this shards it
Megatron-style over the ranks of a tensor-parallel group:

  * q / k / v and fc1 column-sharded (their output features): each rank
    computes heads / tp attention heads (the attention kernel runs on the
    local heads as it is) and (4 D) / tp FFN lanes;
  * out_proj and fc2 row-sharded (their input features): the partial
    products are summed with one `all_reduce` each (two a layer), and the
    replicated bias is added once after it (models/esm.py);
  * the embedding, the LayerNorms and every activation replicated.

Where the JAX package runs the sharded program under `shard_map`, here each
rank runs the same module on its own slices.  Usage (every rank):

    mesh = mesh2d(dp=1, tp=2)
    esm = TensorParallelAntibodyESM(mesh, esm_cfg, antibody_len)
    params_lib.load_esm_params(esm.module,
                               shard_esm_params(mesh, full_state), dev, dt)
    Sampler(..., esm_fn=esm)

A rank's batch is its data-parallel rows: every rank of one tensor-parallel
group passes the same rows and gets the same output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from abx_tpu_torch.models.esm import (ESM2, ESM2Config, build_esm_tokens,
                                      extract_antibody_reprs)
from abx_tpu_torch.parallel import mesh as mesh_lib

# Module names (fair-esm naming, models/esm.py):
#   column-parallel -- shard the weight's output axis and the bias;
#   row-parallel    -- shard the weight's input axis, replicate the bias
#                      (added once after the all_reduce).
_COL_PARALLEL = ('q_proj', 'k_proj', 'v_proj', 'fc1')
_ROW_PARALLEL = ('out_proj', 'fc2')


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (dp, tp) process mesh: `data` is this rank's data-parallel group
    (the ranks holding the same ESM slices), `model` its tensor-parallel
    group (consecutive ranks)."""
    data: mesh_lib.Mesh
    model: mesh_lib.Mesh


def mesh2d(dp: int, tp: int, device=None) -> Mesh2D:
    """The (dp, tp) mesh over the dp * tp ranks of the default group: tp
    groups of consecutive ranks ({0..tp-1}, {tp..2tp-1}, ...), dp groups of
    the ranks tp apart.  Every rank calls it (each `new_group` is
    collective)."""
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f'mesh2d: dp {dp} x tp {tp} != world size {world}')
    rank = dist.get_rank()
    tp_group = dp_group = None
    for i in range(dp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if rank // tp == i:
            tp_group = g
    for j in range(tp):
        g = dist.new_group(list(range(j, world, tp)))
        if rank % tp == j:
            dp_group = g
    return Mesh2D(mesh_lib.make_mesh(dp_group, 'data', device),
                  mesh_lib.make_mesh(tp_group, 'model', device))


def esm_param_specs(state: Dict[str, torch.Tensor]
                    ) -> Dict[str, Optional[int]]:
    """For each entry of a fair-esm ESM2 state dict, the axis split over
    the tensor-parallel ranks (counted from the end of the shape, so a
    stacked layout with a leading layer axis takes the same spec) or None
    where it is replicated.  torch keeps a Linear's weight as (out, in)."""
    specs = {}
    for name, v in state.items():
        parts = set(name.split('.'))
        leaf = name.rsplit('.', 1)[-1]
        axis = None
        if parts & set(_COL_PARALLEL):
            axis = -2 if leaf == 'weight' else -1
        elif parts & set(_ROW_PARALLEL) and leaf == 'weight':
            axis = -1
        specs[name] = axis
        if axis is not None and len(v.shape) < -axis:
            raise ValueError(f'{name}: shape {tuple(v.shape)} has no axis '
                             f'{axis}')
    return specs


def shard_esm_params(mesh: Mesh2D, state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full ESM2 state dict (tensors or numpy
    arrays): its contiguous block of each sharded axis, the replicated
    entries whole."""
    tp, r = mesh.model.size, mesh.model.rank
    out = {}
    for name, axis in esm_param_specs(state).items():
        v = torch.as_tensor(state[name])
        if axis is not None:
            n = v.shape[axis]
            if n % tp:
                raise ValueError(f'{name}: axis {axis} of {n} not divisible '
                                 f'by tp {tp}')
            v = v.narrow(axis, r * (n // tp), n // tp)
        out[name] = v
    return out


class TensorParallelAntibodyESM(nn.Module):
    """`models/esm.AntibodyESM` with tensor-parallel ESM2 slices: the same
    call, `(ab_aatype, heavy_len, light_len, layer_weights)`, so the
    Sampler and the Trainer take it as their ESM module.  `layer_weights`
    is required: the layer-weighted sum is accumulated in the layer loop
    (the full per-layer stack is single-rank only)."""

    def __init__(self, mesh: Mesh2D, config: ESM2Config, antibody_len: int,
                 sep_pad_num: int = 48, dtype=torch.bfloat16, device=None):
        super().__init__()
        tp = mesh.model.size
        if config.attention_heads % tp:
            raise ValueError(f'attention_heads={config.attention_heads} not '
                             f'divisible by tp={tp}')
        if (4 * config.embed_dim) % tp:
            raise ValueError(f'ffn={4 * config.embed_dim} not divisible by '
                             f'tp={tp}')
        self.config = config
        self.antibody_len = antibody_len
        self.sep_pad_num = sep_pad_num
        self.module = ESM2(config, dtype=dtype, device=device, tp_size=tp,
                           tp_group=mesh.model.group)

    def forward(self, ab_aatype, heavy_len, light_len, layer_weights=None):
        if layer_weights is None:
            raise ValueError(
                'the tensor-parallel ESM2 computes the layer-weighted sum '
                'in its layer loop: pass layer_weights')
        tokens = build_esm_tokens(ab_aatype, heavy_len, light_len,
                                  self.sep_pad_num)
        reprs = self.module(tokens, layer_weights=layer_weights)
        return extract_antibody_reprs(reprs, heavy_len, light_len,
                                      self.antibody_len, self.sep_pad_num)
