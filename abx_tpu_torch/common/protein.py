"""Protein structure dataclass + PDB serialization.

The port's own copy of `abx_tpu/common/protein.py` (numpy only; the same
names and output).  Parity surface: the reference's abx/common/protein.py
(AF2's `Protein` container with `from_prediction` / `to_pdb`).  The design
path writes PDBs with the atom14 writer in data/pdb_io.py; this module
provides the atom37-level API for interop with AF2-family tooling and the
reference's `pdb_save` path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from abx_tpu_torch.common import residue_constants as rc


@dataclasses.dataclass(frozen=True)
class Protein:
    atom_positions: np.ndarray   # (L, 37, 3)
    aatype: np.ndarray           # (L,)
    atom_mask: np.ndarray        # (L, 37)
    residue_index: np.ndarray    # (L,)
    b_factors: np.ndarray        # (L, 37)
    chain_index: Optional[np.ndarray] = None  # (L,)


def from_prediction(features: Dict[str, Any], result: Dict[str, Any],
                    b_factors: Optional[np.ndarray] = None) -> Protein:
    """Build a Protein from model features + structure-module results."""
    fold = result['structure_module']
    atom_positions = np.asarray(fold['final_atom_positions'])
    atom_mask = np.asarray(fold['final_atom_mask'])
    if atom_positions.shape[-2] != rc.atom_type_num:
        # atom14 -> atom37 scatter.
        aatype = np.asarray(features['aatype'])
        pos37 = np.zeros((len(aatype), 37, 3), np.float32)
        mask37 = np.zeros((len(aatype), 37), np.float32)
        a14_to_37 = rc.restype_atom14_to_atom37[np.clip(aatype, 0, 20)]
        for i in range(len(aatype)):
            for j in range(atom_positions.shape[-2]):
                if atom_mask[i, j] > 0:
                    pos37[i, a14_to_37[i, j]] = atom_positions[i, j]
                    mask37[i, a14_to_37[i, j]] = 1.0
        atom_positions, atom_mask = pos37, mask37
    L = atom_positions.shape[0]
    if b_factors is None:
        b_factors = np.zeros((L, rc.atom_type_num))
    chain_index = None
    if 'heavy_len' in features:
        chain_index = (np.arange(L) >= features['heavy_len']).astype(np.int32)
    return Protein(
        atom_positions=atom_positions,
        aatype=np.asarray(features['aatype']),
        atom_mask=atom_mask,
        residue_index=np.asarray(features['residue_index']),
        b_factors=np.asarray(b_factors),
        chain_index=chain_index,
    )


_CHAIN_IDS = 'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz'


def to_pdb(prot: Protein) -> str:
    """Serialize a Protein to PDB text (atom37 layout)."""
    lines = ['MODEL     1']
    serial = 1
    chain_index = (prot.chain_index if prot.chain_index is not None
                   else np.zeros((len(prot.aatype),), np.int32))
    last_chain = None
    for i in range(len(prot.aatype)):
        restype = int(prot.aatype[i])
        resname = rc.restype_1to3.get(
            rc.restypes_with_x[min(restype, rc.restype_num)], 'UNK')
        chain_id = _CHAIN_IDS[int(chain_index[i]) % len(_CHAIN_IDS)]
        if last_chain is not None and chain_id != last_chain:
            lines.append(f'TER   {serial:>5d}')
            serial += 1
        last_chain = chain_id
        for j, atom_name in enumerate(rc.atom_types):
            if prot.atom_mask[i, j] < 0.5:
                continue
            x, y, z = prot.atom_positions[i, j]
            name_field = (f' {atom_name:<3s}' if len(atom_name) < 4
                          else atom_name)
            lines.append(
                f'ATOM  {serial:>5d} {name_field} {resname:>3s} '
                f'{chain_id}{int(prot.residue_index[i]) + 1:>4d}    '
                f'{x:>8.3f}{y:>8.3f}{z:>8.3f}{1.0:>6.2f}'
                f'{prot.b_factors[i, j]:>6.2f}          '
                f'{atom_name[0]:>2s}')
            serial += 1
    lines.append(f'TER   {serial:>5d}')
    lines.append('ENDMDL')
    lines.append('END')
    return '\n'.join(lines) + '\n'
