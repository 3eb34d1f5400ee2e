"""Output heads of the reference model (sequence, pLDDT) and the all-atom
rebuild, in float32."""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference import frames as frame_ops
from benchmark.reference.frames import table
from benchmark.reference.modules import LayerNorm, Linear
from benchmark.reference.rigid import Rigid
from benchmark.reference.tensor import batched_gather


class _MlpHead(nn.Module):
    def __init__(self, config, c_in: int, num_out: int):
        super().__init__()
        hc = config.num_hidden_channel
        self.norm = LayerNorm(c_in)
        self.linear1 = Linear(c_in, hc)
        self.linear2 = Linear(hc, hc)
        self.linear3 = Linear(hc, num_out)

    def logits(self, x):
        x = torch.relu(self.linear1(self.norm(x)))
        x = torch.relu(self.linear2(x))
        return self.linear3(x)


class SequenceHead(_MlpHead):
    """Amino-acid logits; argmax sequence with fixed residues restored."""

    def __init__(self, config, c_in: int, num_res_types: int = 20):
        super().__init__(config, c_in, num_res_types)

    def forward(self, structure_act, batch):
        logits = self.logits(structure_act)
        seq_0 = torch.argmax(logits, dim=-1)
        fixed = batch['fixed_mask'].long()
        seq_0 = seq_0 * (1 - fixed) + batch['seq_t'].long() * fixed
        return {'logits': logits, 'seq_0': seq_0}


def plddt(logits):
    """Expected lDDT percentage from binned logits."""
    num_bins = logits.shape[-1]
    bin_width = 1.0 / num_bins
    centers = torch.arange(num_bins, device=logits.device) * bin_width \
        + bin_width / 2
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.sum(probs * centers, dim=-1) * 100.0


class PredictedLDDTHead(_MlpHead):
    def __init__(self, config, c_in: int, num_bins: int = 50):
        super().__init__(config, c_in, num_bins)

    def forward(self, structure_act):
        logits = self.logits(structure_act)
        return {'logits': logits, 'pLDDT': plddt(logits)}


def rebuild_atoms(seq, rigids7, angles_sin_cos):
    """All-atom rebuild from rigids + torsions with a given sequence."""
    dev = rigids7.device
    seq = seq.long()
    backb = Rigid.from_quat_trans(rigids7[..., :4], rigids7[..., 4:])
    all_frames = frame_ops.torsion_angles_to_frames(seq, backb,
                                                    angles_sin_cos)
    atom14_pos = frame_ops.frames_to_atom14_pos(seq, all_frames)
    residx_atom37_to_atom14 = batched_gather(
        table('restype_atom37_to_atom14', dev), seq)
    atom37_pos = batched_gather(atom14_pos, residx_atom37_to_atom14,
                                batch_dims=2)
    return {'final_atom14_positions': atom14_pos,
            'final_atom_positions': atom37_pos}
