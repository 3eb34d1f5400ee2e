"""Graft a designed Fv back onto the original full antibody.

The port's own copy of `abx_tpu/evaluation/grafting.py` (numpy only), on
the port's numbering and pdb_io.  Parity surface: the reference's
eval/metric_scripts/full_anti.py and the
grafting step of eval/traj_evaluate.py: superpose the designed variable
domain onto the original structure via framework-region CA Kabsch, then
replace the variable-domain residues with the designed ones.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import ChainData
from abx_tpu_torch.evaluation.metrics import apply_kabsch, kabsch
from abx_tpu_torch.preprocess.numbering import annotate_domain


def graft_fv_chain(original: ChainData, designed: ChainData, chain_tag: str
                   ) -> Optional[ChainData]:
    """Graft the designed Fv into the original chain; full ChainData out.

    Framework-region CAs (non-CDR positions of the variable domain) define
    the superposition; designed coordinates, sequence and atom mask replace
    the domain (the designed CDR sequence generally differs from the
    original — reference traj_evaluate.py rebuilds the full antibody with
    the designed residues before packing/scoring).
    """
    ann_orig = annotate_domain(original.str_seq, chain_tag)
    if ann_orig is None or len(designed.str_seq) != (ann_orig.end
                                                     - ann_orig.start):
        return None
    sl = slice(ann_orig.start, ann_orig.end)
    orig_dom_ca = original.coords[sl, 1]
    orig_dom_mask = original.coord_mask[sl, 1]
    des_ca = designed.coords[:, 1]
    des_mask = designed.coord_mask[:, 1]

    cdr_enums = set(rc.cdr_str_to_enum.values())
    framework = ~np.isin(ann_orig.cdr_def, list(cdr_enums))
    sel = framework & (orig_dom_mask > 0) & (des_mask > 0)
    if sel.sum() < 3:
        return None
    rot, trans = kabsch(des_ca[sel], orig_dom_ca[sel])
    placed = apply_kabsch(designed.coords.reshape(-1, 3), rot,
                          trans).reshape(designed.coords.shape)
    coords = original.coords.copy()
    coords[sl] = placed
    mask = original.coord_mask.copy()
    mask[sl] = designed.coord_mask
    str_seq = (original.str_seq[:ann_orig.start] + designed.str_seq
               + original.str_seq[ann_orig.end:])
    return ChainData(original.chain_id, str_seq, coords, mask,
                     list(original.resseq), list(original.icodes))


def graft_fv(original: ChainData, designed: ChainData, chain_tag: str
             ) -> Optional[np.ndarray]:
    """Full-chain atom14 coords with the designed Fv grafted in."""
    grafted = graft_fv_chain(original, designed, chain_tag)
    return None if grafted is None else grafted.coords
