"""Protein / antibody residue-level constant tables.

The reference's own copy of the port's `common/residue_constants.py`:
the same names and values.  All numerical conventions
follow the public AlphaFold 2 definitions (Jumper et al., Nature 2021;
Apache-2.0 reference implementation), which AbX also builds on: atom37 /
atom14 schemas, 8 rigid groups, chi tables, ambiguity swaps, and the
antibody-specific CDR enums.

Everything in this module is host-side numpy; device code converts the
tables to tensors on demand (`geometry/frames.table`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# Antibody-specific constants (parity: reference residue_constants.py:11-21).
# ---------------------------------------------------------------------------

# 6 CDRs + 7 framework/anchor regions + antigen sentinel.
num_ab_regions = 14

# Residue-index gap inserted between heavy and light chain numbering so that
# relative-position features never alias across chains.
residue_chain_index_offset = 512

cdr_str_to_enum = {
    'H1': 1,
    'H2': 3,
    'H3': 5,
    'L1': 8,
    'L2': 10,
    'L3': 12,
}
cdr_enum_to_str = {v: k for k, v in cdr_str_to_enum.items()}

# cdr_def value used for antigen residues.
antigen_cdr_index = 14

# ---------------------------------------------------------------------------
# Amino-acid alphabets.
# ---------------------------------------------------------------------------

restypes = [
    'A', 'R', 'N', 'D', 'C', 'Q', 'E', 'G', 'H', 'I', 'L', 'K', 'M', 'F', 'P',
    'S', 'T', 'W', 'Y', 'V',
]
restype_order: Dict[str, int] = {r: i for i, r in enumerate(restypes)}
restype_num = len(restypes)  # 20.
unk_restype_index = restype_num  # 20 == 'X'.

restypes_with_x = restypes + ['X']
restype_order_with_x = {r: i for i, r in enumerate(restypes_with_x)}

# Token vocabulary used by the model embedders: 20 aa + X + gap + mask.
num_tokens = restype_num + 3

restype_1to3 = {
    'A': 'ALA', 'R': 'ARG', 'N': 'ASN', 'D': 'ASP', 'C': 'CYS',
    'Q': 'GLN', 'E': 'GLU', 'G': 'GLY', 'H': 'HIS', 'I': 'ILE',
    'L': 'LEU', 'K': 'LYS', 'M': 'MET', 'F': 'PHE', 'P': 'PRO',
    'S': 'SER', 'T': 'THR', 'W': 'TRP', 'Y': 'TYR', 'V': 'VAL',
}
restype_3to1 = {v: k for k, v in restype_1to3.items()}
unk_restype = 'UNK'

resnames = [restype_1to3[r] for r in restypes] + [unk_restype]
resname_to_idx = {r: i for i, r in enumerate(resnames)}


def sequence_to_index(seq: str, mapping=None) -> np.ndarray:
    """String sequence -> int array (unknowns map to X)."""
    mapping = mapping or restype_order_with_x
    unk = mapping.get('X', unk_restype_index)
    return np.array([mapping.get(c, unk) for c in seq], dtype=np.int32)


def index_to_sequence(idx) -> str:
    return ''.join(restypes_with_x[min(int(i), restype_num)] for i in idx)


# ---------------------------------------------------------------------------
# atom37 schema.
# ---------------------------------------------------------------------------

atom_types = [
    'N', 'CA', 'C', 'CB', 'O', 'CG', 'CG1', 'CG2', 'OG', 'OG1', 'SG', 'CD',
    'CD1', 'CD2', 'ND1', 'ND2', 'OD1', 'OD2', 'SD', 'CE', 'CE1', 'CE2', 'CE3',
    'NE', 'NE1', 'NE2', 'OE1', 'OE2', 'CH2', 'NH1', 'NH2', 'OH', 'CZ', 'CZ2',
    'CZ3', 'NZ', 'OXT',
]
atom_order: Dict[str, int] = {a: i for i, a in enumerate(atom_types)}
atom_type_num = len(atom_types)  # 37.

# ---------------------------------------------------------------------------
# atom14 schema: the (up to) 14 heavy atoms per residue type, in a fixed order.
# ---------------------------------------------------------------------------

restype_name_to_atom14_names: Dict[str, List[str]] = {
    'ALA': ['N', 'CA', 'C', 'O', 'CB', '', '', '', '', '', '', '', '', ''],
    'ARG': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'NE', 'CZ', 'NH1', 'NH2',
            '', '', ''],
    'ASN': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'OD1', 'ND2', '', '', '', '', '',
            ''],
    'ASP': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'OD1', 'OD2', '', '', '', '', '',
            ''],
    'CYS': ['N', 'CA', 'C', 'O', 'CB', 'SG', '', '', '', '', '', '', '', ''],
    'GLN': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'OE1', 'NE2', '', '', '',
            '', ''],
    'GLU': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'OE1', 'OE2', '', '', '',
            '', ''],
    'GLY': ['N', 'CA', 'C', 'O', '', '', '', '', '', '', '', '', '', ''],
    'HIS': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'ND1', 'CD2', 'CE1', 'NE2', '',
            '', '', ''],
    'ILE': ['N', 'CA', 'C', 'O', 'CB', 'CG1', 'CG2', 'CD1', '', '', '', '',
            '', ''],
    'LEU': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', '', '', '', '', '',
            ''],
    'LYS': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'CE', 'NZ', '', '', '', '',
            ''],
    'MET': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'SD', 'CE', '', '', '', '', '',
            ''],
    'PHE': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ',
            '', '', ''],
    'PRO': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', '', '', '', '', '', '', ''],
    'SER': ['N', 'CA', 'C', 'O', 'CB', 'OG', '', '', '', '', '', '', '', ''],
    'THR': ['N', 'CA', 'C', 'O', 'CB', 'OG1', 'CG2', '', '', '', '', '', '',
            ''],
    'TRP': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'NE1', 'CE2',
            'CE3', 'CZ2', 'CZ3', 'CH2'],
    'TYR': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ',
            'OH', '', ''],
    'VAL': ['N', 'CA', 'C', 'O', 'CB', 'CG1', 'CG2', '', '', '', '', '', '',
            ''],
    'UNK': ['', '', '', '', '', '', '', '', '', '', '', '', '', ''],
}

# ---------------------------------------------------------------------------
# Chi angles.
# ---------------------------------------------------------------------------

chi_angles_atoms: Dict[str, List[List[str]]] = {
    'ALA': [],
    'ARG': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'],
            ['CB', 'CG', 'CD', 'NE'], ['CG', 'CD', 'NE', 'CZ']],
    'ASN': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'OD1']],
    'ASP': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'OD1']],
    'CYS': [['N', 'CA', 'CB', 'SG']],
    'GLN': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'],
            ['CB', 'CG', 'CD', 'OE1']],
    'GLU': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'],
            ['CB', 'CG', 'CD', 'OE1']],
    'GLY': [],
    'HIS': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'ND1']],
    'ILE': [['N', 'CA', 'CB', 'CG1'], ['CA', 'CB', 'CG1', 'CD1']],
    'LEU': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'LYS': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'],
            ['CB', 'CG', 'CD', 'CE'], ['CG', 'CD', 'CE', 'NZ']],
    'MET': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'SD'],
            ['CB', 'CG', 'SD', 'CE']],
    'PHE': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'PRO': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD']],
    'SER': [['N', 'CA', 'CB', 'OG']],
    'THR': [['N', 'CA', 'CB', 'OG1']],
    'TRP': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'TYR': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'VAL': [['N', 'CA', 'CB', 'CG1']],
}

# Which chi angles exist per residue type (20, 4).
chi_angles_mask = np.zeros([restype_num + 1, 4], dtype=np.float32)
for _i, _r in enumerate(restypes):
    _n = len(chi_angles_atoms[restype_1to3[_r]])
    chi_angles_mask[_i, :_n] = 1.0

# chi angles that are 180-degree ambiguous (same heavy-atom arrangement when
# rotated by pi): chi2 of ASP/PHE/TYR, chi3 of GLU.
chi_pi_periodic = np.zeros([restype_num + 1, 4], dtype=np.float32)
for _r, _chis in [('ASP', [1]), ('GLU', [2]), ('PHE', [1]), ('TYR', [1])]:
    for _c in _chis:
        chi_pi_periodic[restype_order[restype_3to1[_r]], _c] = 1.0

# atom37 indices of the 4 atoms defining each chi, per residue (21, 4, 4).
chi_angles_atom_indices = np.zeros([restype_num + 1, 4, 4], dtype=np.int32)
for _i, _r in enumerate(restypes):
    for _c, _atoms in enumerate(chi_angles_atoms[restype_1to3[_r]]):
        for _a, _name in enumerate(_atoms):
            chi_angles_atom_indices[_i, _c, _a] = atom_order[_name]

# ---------------------------------------------------------------------------
# Rigid-group definitions (8 groups per residue):
#   0: backbone, 1: pre-omega, 2: phi, 3: psi, 4-7: chi1-chi4.
# `rigid_group_atom_positions[res] = [(atom_name, group_idx, (x, y, z)), ...]`
# with positions in the idealised literature frame of the owning group.
# These are the standard AlphaFold 2 idealised coordinates.
# ---------------------------------------------------------------------------

rigid_group_atom_positions: Dict[str, list] = {
    'ALA': [
        ['N', 0, (-0.525, 1.363, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, -0.000, -0.000)],
        ['CB', 0, (-0.529, -0.774, -1.205)],
        ['O', 3, (0.627, 1.062, 0.000)],
    ],
    'ARG': [
        ['N', 0, (-0.524, 1.362, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, -0.000, -0.000)],
        ['CB', 0, (-0.524, -0.778, -1.209)],
        ['O', 3, (0.626, 1.062, 0.000)],
        ['CG', 4, (0.616, 1.390, -0.000)],
        ['CD', 5, (0.564, 1.414, 0.000)],
        ['NE', 6, (0.539, 1.357, -0.000)],
        ['NH1', 7, (0.206, 2.301, 0.000)],
        ['NH2', 7, (2.078, 0.978, -0.000)],
        ['CZ', 7, (0.758, 1.093, -0.000)],
    ],
    'ASN': [
        ['N', 0, (-0.536, 1.357, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, -0.000, -0.000)],
        ['CB', 0, (-0.531, -0.787, -1.200)],
        ['O', 3, (0.625, 1.062, 0.000)],
        ['CG', 4, (0.584, 1.399, 0.000)],
        ['ND2', 5, (0.593, -1.188, 0.001)],
        ['OD1', 5, (0.633, 1.059, 0.000)],
    ],
    'ASP': [
        ['N', 0, (-0.525, 1.362, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.527, 0.000, -0.000)],
        ['CB', 0, (-0.526, -0.778, -1.208)],
        ['O', 3, (0.626, 1.062, -0.000)],
        ['CG', 4, (0.593, 1.398, -0.000)],
        ['OD1', 5, (0.610, 1.091, 0.000)],
        ['OD2', 5, (0.592, -1.101, -0.003)],
    ],
    'CYS': [
        ['N', 0, (-0.522, 1.362, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.524, 0.000, 0.000)],
        ['CB', 0, (-0.519, -0.773, -1.212)],
        ['O', 3, (0.625, 1.062, -0.000)],
        ['SG', 4, (0.728, 1.653, 0.000)],
    ],
    'GLN': [
        ['N', 0, (-0.526, 1.361, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, 0.000, 0.000)],
        ['CB', 0, (-0.525, -0.779, -1.207)],
        ['O', 3, (0.626, 1.062, -0.000)],
        ['CG', 4, (0.615, 1.393, 0.000)],
        ['CD', 5, (0.587, 1.399, -0.000)],
        ['NE2', 6, (0.593, -1.189, -0.001)],
        ['OE1', 6, (0.634, 1.060, 0.000)],
    ],
    'GLU': [
        ['N', 0, (-0.528, 1.361, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, -0.000, -0.000)],
        ['CB', 0, (-0.526, -0.781, -1.207)],
        ['O', 3, (0.626, 1.062, 0.000)],
        ['CG', 4, (0.615, 1.392, 0.000)],
        ['CD', 5, (0.600, 1.397, 0.000)],
        ['OE1', 6, (0.607, 1.095, -0.000)],
        ['OE2', 6, (0.589, -1.104, -0.001)],
    ],
    'GLY': [
        ['N', 0, (-0.572, 1.337, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.517, -0.000, -0.000)],
        ['O', 3, (0.626, 1.062, -0.000)],
    ],
    'HIS': [
        ['N', 0, (-0.527, 1.360, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, 0.000, 0.000)],
        ['CB', 0, (-0.525, -0.778, -1.208)],
        ['O', 3, (0.625, 1.063, 0.000)],
        ['CG', 4, (0.600, 1.370, -0.000)],
        ['CD2', 5, (0.889, -1.021, 0.003)],
        ['ND1', 5, (0.744, 1.160, -0.000)],
        ['CE1', 5, (2.030, 0.851, 0.002)],
        ['NE2', 5, (2.145, -0.466, 0.004)],
    ],
    'ILE': [
        ['N', 0, (-0.493, 1.373, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.527, -0.000, -0.000)],
        ['CB', 0, (-0.536, -0.793, -1.213)],
        ['O', 3, (0.627, 1.062, -0.000)],
        ['CG1', 4, (0.534, 1.437, -0.000)],
        ['CG2', 4, (0.540, -0.785, -1.199)],
        ['CD1', 5, (0.619, 1.391, 0.000)],
    ],
    'LEU': [
        ['N', 0, (-0.520, 1.363, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, -0.000, -0.000)],
        ['CB', 0, (-0.522, -0.773, -1.214)],
        ['O', 3, (0.625, 1.063, -0.000)],
        ['CG', 4, (0.678, 1.371, 0.000)],
        ['CD1', 5, (0.530, 1.430, -0.000)],
        ['CD2', 5, (0.535, -0.774, 1.200)],
    ],
    'LYS': [
        ['N', 0, (-0.526, 1.362, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, 0.000, 0.000)],
        ['CB', 0, (-0.524, -0.778, -1.208)],
        ['O', 3, (0.626, 1.062, -0.000)],
        ['CG', 4, (0.619, 1.390, 0.000)],
        ['CD', 5, (0.559, 1.417, 0.000)],
        ['CE', 6, (0.560, 1.416, 0.000)],
        ['NZ', 7, (0.554, 1.387, 0.000)],
    ],
    'MET': [
        ['N', 0, (-0.521, 1.364, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, 0.000, 0.000)],
        ['CB', 0, (-0.523, -0.776, -1.210)],
        ['O', 3, (0.625, 1.062, -0.000)],
        ['CG', 4, (0.613, 1.391, -0.000)],
        ['SD', 5, (0.703, 1.695, 0.000)],
        ['CE', 6, (0.320, 1.786, -0.000)],
    ],
    'PHE': [
        ['N', 0, (-0.518, 1.363, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.524, 0.000, -0.000)],
        ['CB', 0, (-0.525, -0.776, -1.212)],
        ['O', 3, (0.626, 1.062, -0.000)],
        ['CG', 4, (0.607, 1.377, 0.000)],
        ['CD1', 5, (0.709, 1.195, -0.000)],
        ['CD2', 5, (0.706, -1.196, 0.000)],
        ['CE1', 5, (2.102, 1.198, -0.000)],
        ['CE2', 5, (2.098, -1.201, -0.000)],
        ['CZ', 5, (2.794, -0.003, -0.001)],
    ],
    'PRO': [
        ['N', 0, (-0.566, 1.351, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.527, -0.000, 0.000)],
        ['CB', 0, (-0.546, -0.611, -1.293)],
        ['O', 3, (0.621, 1.066, 0.000)],
        ['CG', 4, (0.382, 1.445, 0.0)],
        ['CD', 5, (0.477, 1.424, 0.0)],
    ],
    'SER': [
        ['N', 0, (-0.529, 1.360, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, -0.000, -0.000)],
        ['CB', 0, (-0.518, -0.777, -1.211)],
        ['O', 3, (0.626, 1.062, -0.000)],
        ['OG', 4, (0.503, 1.325, 0.000)],
    ],
    'THR': [
        ['N', 0, (-0.517, 1.364, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.526, 0.000, -0.000)],
        ['CB', 0, (-0.516, -0.793, -1.215)],
        ['O', 3, (0.626, 1.062, 0.000)],
        ['CG2', 4, (0.550, -0.718, -1.228)],
        ['OG1', 4, (0.472, 1.353, 0.000)],
    ],
    'TRP': [
        ['N', 0, (-0.521, 1.363, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.525, -0.000, 0.000)],
        ['CB', 0, (-0.523, -0.776, -1.212)],
        ['O', 3, (0.627, 1.062, 0.000)],
        ['CG', 4, (0.609, 1.370, -0.000)],
        ['CD1', 5, (0.824, 1.091, 0.000)],
        ['CD2', 5, (0.854, -1.148, -0.005)],
        ['CE2', 5, (2.186, -0.678, -0.007)],
        ['CE3', 5, (0.622, -2.530, -0.007)],
        ['NE1', 5, (2.140, 0.690, -0.004)],
        ['CH2', 5, (3.028, -2.890, -0.013)],
        ['CZ2', 5, (3.283, -1.543, -0.011)],
        ['CZ3', 5, (1.715, -3.389, -0.011)],
    ],
    'TYR': [
        ['N', 0, (-0.522, 1.362, 0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.524, -0.000, -0.000)],
        ['CB', 0, (-0.522, -0.776, -1.213)],
        ['O', 3, (0.627, 1.062, -0.000)],
        ['CG', 4, (0.607, 1.382, -0.000)],
        ['CD1', 5, (0.716, 1.195, -0.000)],
        ['CD2', 5, (0.713, -1.194, -0.001)],
        ['CE1', 5, (2.107, 1.200, -0.002)],
        ['CE2', 5, (2.104, -1.201, -0.003)],
        ['OH', 5, (4.168, -0.002, -0.005)],
        ['CZ', 5, (2.791, -0.001, -0.003)],
    ],
    'VAL': [
        ['N', 0, (-0.494, 1.373, -0.000)],
        ['CA', 0, (0.000, 0.000, 0.000)],
        ['C', 0, (1.527, -0.000, -0.000)],
        ['CB', 0, (-0.533, -0.795, -1.213)],
        ['O', 3, (0.627, 1.062, -0.000)],
        ['CG1', 4, (0.540, 1.429, -0.000)],
        ['CG2', 4, (0.533, -0.776, 1.203)],
    ],
    'UNK': [],
}

# Atoms whose naming is 180-degree ambiguous (swap partners).
residue_atom_renaming_swaps = {
    'ASP': {'OD1': 'OD2'},
    'GLU': {'OE1': 'OE2'},
    'PHE': {'CD1': 'CD2', 'CE1': 'CE2'},
    'TYR': {'CD1': 'CD2', 'CE1': 'CE2'},
}

# Van der Waals radii (Angstroms) by element, for clash terms.
van_der_waals_radius = {'C': 1.7, 'N': 1.55, 'O': 1.52, 'S': 1.8}

# Between-residue ideal bond geometry (literature values used by AF2's
# structural-violation math; see eval/metric_scripts/cal_vio.py:29-113 in the
# reference for the consumer).
between_res_bond_length_c_n = [1.329, 1.341]  # [general, pre-proline]
between_res_bond_length_stddev_c_n = [0.014, 0.016]
between_res_cos_angles_c_n_ca = [-0.5203, 0.0353]  # cos(121.352 +- 2.315 deg)
between_res_cos_angles_ca_c_n = [-0.4473, 0.0311]  # cos(116.568 +- 1.995 deg)

# ---------------------------------------------------------------------------
# Derived static tables.
# ---------------------------------------------------------------------------


def _build_atom14_tables():
    """atom14 <-> atom37 cross maps and existence masks."""
    n_res = restype_num + 1
    a14_to_a37 = np.zeros([n_res, 14], dtype=np.int32)
    a37_to_a14 = np.zeros([n_res, 37], dtype=np.int32)
    a14_mask = np.zeros([n_res, 14], dtype=np.float32)
    a37_mask = np.zeros([n_res, 37], dtype=np.float32)
    for i, r in enumerate(restypes):
        names = restype_name_to_atom14_names[restype_1to3[r]]
        for j, name in enumerate(names):
            if not name:
                continue
            a37_idx = atom_order[name]
            a14_to_a37[i, j] = a37_idx
            a37_to_a14[i, a37_idx] = j
            a14_mask[i, j] = 1.0
            a37_mask[i, a37_idx] = 1.0
    return a14_to_a37, a37_to_a14, a14_mask, a37_mask


(restype_atom14_to_atom37, restype_atom37_to_atom14, restype_atom14_mask,
 restype_atom37_mask) = _build_atom14_tables()


def _build_ambiguity_tables():
    """Per-residue ambiguous-atom mask and atom14 swap-index table."""
    n_res = restype_num + 1
    is_ambiguous = np.zeros([n_res, 14], dtype=np.float32)
    swap_index = np.tile(np.arange(14, dtype=np.int32), (n_res, 1))
    for resname, swaps in residue_atom_renaming_swaps.items():
        r = restype_order[restype_3to1[resname]]
        names = restype_name_to_atom14_names[resname]
        for a, b in swaps.items():
            ia, ib = names.index(a), names.index(b)
            is_ambiguous[r, ia] = 1.0
            is_ambiguous[r, ib] = 1.0
            swap_index[r, ia] = ib
            swap_index[r, ib] = ia
    return is_ambiguous, swap_index


restype_atom14_is_ambiguous, restype_ambiguous_atoms_swap_index = (
    _build_ambiguity_tables())


def _rigid_from_ex_ey(ex, ey, translation):
    """4x4 rigid whose x-axis is ex and xy-plane holds ey (Gram-Schmidt)."""
    ex = np.asarray(ex, dtype=np.float64)
    ey = np.asarray(ey, dtype=np.float64)
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = ex, ey, ez
    m[:3, 3] = translation
    return m.astype(np.float32)


def _build_rigid_group_tables():
    """Default frames, atom->group maps, and literature atom positions.

    Group semantics (AF2): 0 backbone, 1 pre-omega (== id), 2 phi, 3 psi,
    4..7 chi1..chi4.  Frames are defined relative to their parent group.
    """
    n_res = restype_num + 1
    default_frame = np.zeros([n_res, 8, 4, 4], dtype=np.float32)
    atom14_to_group = np.zeros([n_res, 14], dtype=np.int32)
    atom14_group_positions = np.zeros([n_res, 14, 3], dtype=np.float32)
    group_mask = np.zeros([n_res, 8], dtype=np.float32)
    base_atom37_idx = np.zeros([n_res, 8, 3], dtype=np.int32)
    # UNK has identity frames but no groups.
    default_frame[:] = np.eye(4)

    for i, r in enumerate(restypes):
        resname = restype_1to3[r]
        atom_positions = {
            name: np.array(pos, dtype=np.float32)
            for name, _, pos in rigid_group_atom_positions[resname]
        }
        atom_groups = {
            name: g for name, g, _ in rigid_group_atom_positions[resname]
        }
        names14 = restype_name_to_atom14_names[resname]
        for j, name in enumerate(names14):
            if not name:
                continue
            atom14_to_group[i, j] = atom_groups[name]
            atom14_group_positions[i, j] = atom_positions[name]

        # Group 0 (backbone) and 1 (pre-omega): identity.  Groups 1 and 2
        # have default frames but no own atoms, so they do not "exist" for
        # frame extraction from coordinates.
        default_frame[i, 0] = np.eye(4)
        default_frame[i, 1] = np.eye(4)
        group_mask[i, 0] = 1.0

        # Group 2 (phi): frame from N.
        default_frame[i, 2] = _rigid_from_ex_ey(
            atom_positions['N'] - atom_positions['CA'],
            np.array([1.0, 0.0, 0.0]), atom_positions['N'])

        # Group 3 (psi): frame from C, y towards N.
        default_frame[i, 3] = _rigid_from_ex_ey(
            atom_positions['C'] - atom_positions['CA'],
            atom_positions['CA'] - atom_positions['N'], atom_positions['C'])
        group_mask[i, 3] = 1.0

        # Chi groups.
        chis = chi_angles_atoms[resname]
        if chis:
            # chi1 frame relative to backbone.
            base = [atom_positions[a] for a in chis[0][:3]]
            default_frame[i, 4] = _rigid_from_ex_ey(
                base[2] - base[1], base[0] - base[1], base[2])
            group_mask[i, 4] = 1.0
        for k in range(1, len(chis)):
            # chi_{k+1} relative to chi_k: the axis atom sits at the origin of
            # the next frame; in the parent frame its position is stored.
            axis_end = atom_positions[chis[k][2]]
            default_frame[i, 4 + k] = _rigid_from_ex_ey(
                axis_end, np.array([-1.0, 0.0, 0.0]), axis_end)
            group_mask[i, 4 + k] = 1.0

        # Base atoms (atom37 indices) used to compute each group frame from
        # actual coordinates: (point_on_neg_x_axis, origin, point_on_xy_plane).
        ca, n_at, c_at = atom_order['CA'], atom_order['N'], atom_order['C']
        base_atom37_idx[i, 0] = [c_at, ca, n_at]
        base_atom37_idx[i, 1] = [ca, ca, n_at]   # placeholder (pre-omega)
        base_atom37_idx[i, 2] = [ca, ca, n_at]   # phi placeholder
        base_atom37_idx[i, 3] = [ca, c_at, atom_order['O']]
        for k, chi in enumerate(chis):
            base_atom37_idx[i, 4 + k] = [
                atom_order[chi[1]], atom_order[chi[2]], atom_order[chi[3]]]
    return (default_frame, atom14_to_group, atom14_group_positions, group_mask,
            base_atom37_idx)


(restype_rigid_group_default_frame, restype_atom14_to_rigid_group,
 restype_atom14_rigid_group_positions, restype_rigidgroup_mask,
 restype_rigidgroup_base_atom37_idx) = _build_rigid_group_tables()


def _build_rigidgroup_ambiguity():
    """Which rigid groups are 180-deg ambiguous + the flipping rotations."""
    n_res = restype_num + 1
    is_ambiguous = np.zeros([n_res, 8], dtype=np.float32)
    rots = np.tile(np.eye(3, dtype=np.float32), (n_res, 8, 1, 1))
    for resname, _ in residue_atom_renaming_swaps.items():
        r = restype_order[restype_3to1[resname]]
        chi = int(np.argmax(chi_pi_periodic[r]))  # ambiguous chi index.
        group = 4 + chi
        is_ambiguous[r, group] = 1.0
        # Rotation by pi about the x (bond) axis.
        rots[r, group] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return is_ambiguous, rots


restype_rigidgroup_is_ambiguous, restype_rigidgroup_rots = (
    _build_rigidgroup_ambiguity())
