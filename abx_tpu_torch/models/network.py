"""Top-level score network with recycling.

Counterpart of abx_tpu/models/network.py: `ScoreNetworkIteration` (trunk +
ordered heads, and with `compute_loss` the distogram and metric heads of
the loss pass) and `forward_with_recycling`, which runs `num_recycle`
no-grad passes feeding back prev_pos / prev_seq / prev_pair and the
predicted sequence, then the final pass in the caller's grad mode.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from abx_tpu_torch.geometry import frames as frame_ops
from abx_tpu_torch.models import metric_heads
from abx_tpu_torch.models.heads import (DistogramHead, PredictedLDDTHead,
                                        SequenceHead, rebuild_atoms)
from abx_tpu_torch.models.ipa import IpaScore
from abx_tpu_torch.models.seqformer import EmbeddingAndSeqformer
from abx_tpu_torch.utils.prof import annotate


def get_prev(batch, outputs, prev_pos_config) -> Dict[str, torch.Tensor]:
    """Recycling features from a forward pass; prev_seq / prev_pair stay in
    the trunk dtype."""
    atom37 = outputs['heads']['folding']['final_atom_positions']
    pb = frame_ops.pseudo_beta_virtual(atom37)
    prev_pos = frame_ops.dgram_from_positions(
        pb, prev_pos_config.num_bins, prev_pos_config.min_bin,
        prev_pos_config.max_bin)
    return {
        'prev_pos': prev_pos,
        'prev_seq': outputs['representations']['seq'].detach(),
        'prev_pair': outputs['representations']['pair'].detach(),
    }


def zero_prev(batch_size: int, num_res: int, config, dtype=torch.float32,
              device='cpu') -> Dict[str, torch.Tensor]:
    """Zero recycling features in the trunk dtype."""
    c = config.embeddings_and_seqformer
    seq_ch = c.seq_channel + c.index_embed_size
    pair_ch = c.pair_channel + 2 * c.index_embed_size
    return {
        'prev_pos': torch.zeros((batch_size, num_res, num_res),
                                dtype=torch.long, device=device),
        'prev_seq': torch.zeros((batch_size, num_res, seq_ch), dtype=dtype,
                                device=device),
        'prev_pair': torch.zeros((batch_size, num_res, num_res, pair_ch),
                                 dtype=dtype, device=device),
    }


class ScoreNetworkIteration(nn.Module):
    """One trunk pass + heads.  Submodule names follow the flax tree
    (`params/impl/...`) so `utils/params.py` maps weights by name."""

    def __init__(self, config, diffuser, antibody_len: int,
                 dtype=torch.float32):
        super().__init__()
        c = config
        es = c.embeddings_and_seqformer
        seq_c = es.seq_channel + es.index_embed_size
        pair_c = es.pair_channel + 2 * es.index_embed_size
        self.config = c
        self.dtype = dtype
        self.antibody_len = antibody_len
        self.seqformer = EmbeddingAndSeqformer(es, antibody_len, dtype)
        self.diffusion_module = IpaScore(c.heads.diffusion_module, diffuser,
                                         seq_c, pair_c, dtype)
        nc = c.heads.diffusion_module.IPA.num_channel
        self.sequence_module = SequenceHead(c.heads.sequence_module, nc,
                                            dtype=dtype)
        self.predicted_lddt = PredictedLDDTHead(c.heads.predicted_lddt, nc,
                                                dtype=dtype)
        self.distogram = DistogramHead(c.heads.distogram, pair_c, dtype)

    def static_embeddings(self, batch):
        return self.seqformer.static_embeddings(batch)

    def esm_layer_weights(self):
        return self.seqformer.esm_layer_weights()

    def forward(self, batch, static_acts=None, esm_fn=None,
                compute_loss: bool = False, generator=None):
        """One pass.  `compute_loss` adds the distogram head, the contact
        metrics (when the batch has `pseudo_beta`) and the TM-score;
        `generator` draws the dropout in train() mode."""
        seq_act, pair_act = self.seqformer(batch, static_acts=static_acts,
                                           esm_fn=esm_fn, generator=generator)
        representations = {'seq': seq_act, 'pair': pair_act}
        folding = self.diffusion_module(representations, batch, generator)
        with annotate('abx.heads'):
            seq_out = self.sequence_module(folding['structure_act'], batch)
            folding.update(rebuild_atoms(seq_out['seq_0'], folding['rigids'],
                                         folding['angles_sin_cos'], batch))
            heads = {
                'folding': folding,
                'sequence_module': seq_out,
                'predicted_lddt': self.predicted_lddt(
                    folding['structure_act']),
            }
            if compute_loss:
                heads['distogram'] = self.distogram(pair_act)
                if 'pseudo_beta' in batch:
                    heads['metric'] = metric_heads.metric_dict_head(
                        heads['distogram'], batch,
                        self.config.heads.get('metric', None))
                heads['tmscore'] = metric_heads.tmscore_head(folding, batch)
        return {'representations': representations, 'heads': heads}


def forward_with_recycling(apply_single, batch, num_recycle: int,
                           prev_pos_cfg, compute_loss: bool = False):
    """`num_recycle` recycle passes without grad (the JAX package's
    stop_gradients on prev_* and seq_t), then the final pass in the
    caller's grad mode, the only one given `compute_loss`.

    apply_single: fn(batch, compute_loss=...) -> outputs of ONE pass.  The
    trainer's closure shares one `static_acts` across the passes (so they
    get gradient from the final pass only) and one dropout generator,
    whose draws differ from pass to pass.  The returned dict carries
    `recycled_seq_t`, the seq_t the final pass consumed (the last recycle
    pass's predicted seq_0): the reference mutates seq_t in place during
    recycling and its sampler reads the mutated value.  Under a profiler
    each `apply_single` call is the span `abx.pass`; the recycling features
    between passes are not part of it.
    """
    if 'prev_seq' not in batch:
        raise ValueError('caller must seed prev_* (use zero_prev)')
    mb = dict(batch)
    mb['seq_t'] = batch['seq_t'].long()
    with torch.no_grad():
        for _ in range(num_recycle):
            with annotate('abx.pass'):
                out = apply_single(mb, compute_loss=False)
            mb.update(get_prev(mb, out, prev_pos_cfg))
            mb['seq_t'] = out['heads']['sequence_module']['seq_0']
    with annotate('abx.pass'):
        out = apply_single(mb, compute_loss=compute_loss)
    out['recycled_seq_t'] = mb['seq_t']
    return out
