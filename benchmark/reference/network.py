"""The reference score network: one trunk pass with its heads, and the
recycling loop of one reverse step, in float32.

`forward_with_recycling` can take the discrete inputs of the later passes
(the recycled sequence and the binned recycled positions) from the caller:
the benchmark hands it those of the program it checks, so that a token
that flips on rounding between two near-equal logits, or a distance that
crosses a bin edge, does not carry into the passes after it, while the
continuous recycled features stay the reference's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from benchmark.reference import frames as frame_ops
from benchmark.reference.heads import (PredictedLDDTHead, SequenceHead,
                                       rebuild_atoms)
from benchmark.reference.ipa import IpaScore
from benchmark.reference.modules import Linear
from benchmark.reference.seqformer import EmbeddingAndSeqformer


class DistogramHead(nn.Module):
    """Held for the state dict; a design step does not run it."""

    def __init__(self, config, pair_c: int):
        super().__init__()
        self.proj = Linear(pair_c, config.num_bins)


def get_prev(outputs, prev_pos_config) -> Dict[str, torch.Tensor]:
    """Recycling features from a forward pass."""
    atom37 = outputs['folding']['final_atom_positions']
    pb = frame_ops.pseudo_beta_virtual(atom37)
    return {
        'prev_pos': frame_ops.dgram_from_positions(
            pb, prev_pos_config.num_bins, prev_pos_config.min_bin,
            prev_pos_config.max_bin),
        'prev_seq': outputs['seq'],
        'prev_pair': outputs['pair'],
    }


class ScoreNetworkIteration(nn.Module):
    """One trunk pass + heads, with the port's submodule names."""

    def __init__(self, config, diffuser, antibody_len: int):
        super().__init__()
        c = config
        es = c.embeddings_and_seqformer
        seq_c = es.seq_channel + es.index_embed_size
        pair_c = es.pair_channel + 2 * es.index_embed_size
        self.config = c
        self.antibody_len = antibody_len
        self.seqformer = EmbeddingAndSeqformer(es, antibody_len)
        self.diffusion_module = IpaScore(c.heads.diffusion_module, diffuser,
                                         seq_c, pair_c)
        nc = c.heads.diffusion_module.IPA.num_channel
        self.sequence_module = SequenceHead(c.heads.sequence_module, nc)
        self.predicted_lddt = PredictedLDDTHead(c.heads.predicted_lddt, nc)
        self.distogram = DistogramHead(c.heads.distogram, pair_c)

    def static_embeddings(self, batch):
        return self.seqformer.static_embeddings(batch)

    def forward(self, batch, static_acts, esm_fn=None):
        seq_act, pair_act = self.seqformer(batch, static_acts, esm_fn)
        folding = self.diffusion_module({'seq': seq_act, 'pair': pair_act},
                                        batch)
        seq_out = self.sequence_module(folding['structure_act'], batch)
        folding.update(rebuild_atoms(seq_out['seq_0'], folding['rigids'],
                                     folding['angles_sin_cos']))
        return {'seq': seq_act, 'pair': pair_act, 'folding': folding,
                'sequence': seq_out}


def forward_with_recycling(model: ScoreNetworkIteration, batch, static_acts,
                           num_recycle: int, prev_pos_cfg, esm_fn=None,
                           forced: Optional[Sequence[Dict]] = None,
                           esm_out: Optional[list] = None):
    """`num_recycle` recycle passes and the final one.  `forced[p]`, for
    pass p >= 1, may hold the pass's `seq_t` and `prev_pos`, which then
    replace the ones the reference derives.  `esm_out` collects the ESM2
    embedding of each pass.  Returns the final pass's outputs."""
    mb = dict(batch)
    mb['seq_t'] = batch['seq_t'].long()

    def esm(*args):
        out = esm_fn(*args)
        if esm_out is not None:
            esm_out.append(out)
        return out

    out = None
    for p in range(num_recycle + 1):
        if p:
            mb.update(get_prev(out, prev_pos_cfg))
            mb['seq_t'] = out['sequence']['seq_0']
            if forced and forced[p]:
                mb.update(forced[p])
        out = model(mb, static_acts, esm if esm_fn is not None else None)
    out['recycled_seq_t'] = mb['seq_t']
    return out
