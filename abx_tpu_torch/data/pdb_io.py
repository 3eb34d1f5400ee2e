"""Minimal, dependency-free PDB reading/writing.

The port's own copy of the parts of `abx_tpu/data/pdb_io.py` that it calls:
`parse_pdb` (ATOM records of the first model, chains, insertion codes,
altlocs), the SEQRES re-indexing of gappy chains (`parse_seqres`,
`expand_to_seqres`) and `save_complex_pdb` (AF2-style PDBs with pLDDT
b-factors), with the same names and output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from abx_tpu_torch.common import residue_constants as rc


@dataclasses.dataclass
class ChainData:
    """Per-chain parse result in atom14 layout."""
    chain_id: str
    str_seq: str
    coords: np.ndarray       # (N, 14, 3) float32
    coord_mask: np.ndarray   # (N, 14) bool
    resseq: List[int]        # author residue numbers
    icodes: List[str]


def parse_pdb(path: str) -> Dict[str, ChainData]:
    """Parse the first model of a PDB file into per-chain atom14 features.

    Only standard amino-acid residues are kept (parity with the reference's
    `make_chain_feature`, make_ab_data_from_mmcif.py:49-72).
    """
    chains: Dict[str, dict] = {}
    seen_model = False
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        for line in f:
            rec = line[:6]
            if rec == 'MODEL ':
                if seen_model:
                    break
                seen_model = True
            elif rec == 'ENDMDL':
                break
            if rec != 'ATOM  ':
                continue
            altloc = line[16]
            if altloc not in (' ', 'A'):
                continue
            resname = line[17:20].strip()
            if resname not in rc.restype_name_to_atom14_names:
                continue
            atom_name = line[12:16].strip()
            chain_id = line[21]
            resseq = int(line[22:26])
            icode = line[26]
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])

            chain = chains.setdefault(chain_id, {'residues': {}, 'order': []})
            key = (resseq, icode)
            if key not in chain['residues']:
                chain['residues'][key] = {'resname': resname, 'atoms': {}}
                chain['order'].append(key)
            res = chain['residues'][key]
            if res['resname'] != resname:
                continue  # mixed altloc residue naming; keep first
            res['atoms'].setdefault(atom_name, (x, y, z))

    out: Dict[str, ChainData] = {}
    for chain_id, chain in chains.items():
        keys = chain['order']
        n = len(keys)
        coords = np.zeros((n, 14, 3), dtype=np.float32)
        mask = np.zeros((n, 14), dtype=bool)
        seq_chars = []
        resseqs, icodes = [], []
        for i, key in enumerate(keys):
            res = chain['residues'][key]
            resname = res['resname']
            seq_chars.append(rc.restype_3to1.get(resname, 'X'))
            names14 = rc.restype_name_to_atom14_names[resname]
            for atom_name, xyz in res['atoms'].items():
                if atom_name in names14:
                    j = names14.index(atom_name)
                    coords[i, j] = xyz
                    mask[i, j] = True
            resseqs.append(key[0])
            icodes.append(key[1])
        out[chain_id] = ChainData(
            chain_id=chain_id, str_seq=''.join(seq_chars), coords=coords,
            coord_mask=mask, resseq=resseqs, icodes=icodes)
    return out


def parse_seqres(path: str) -> Dict[str, str]:
    """SEQRES records -> per-chain full sequence (1-letter, X for nonstd).

    PDB-format counterpart of the mmCIF `_pdbx_poly_seq_scheme` handling
    (reference abx/preprocess/parser.py:77-135 aligns structure residues to
    the SEQRES sequence so missing-density residues keep their positions).
    """
    seqs: Dict[str, List[str]] = {}
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        for line in f:
            if line[:6] != 'SEQRES':
                continue
            chain_id = line[11]
            for resname in line[19:70].split():
                seqs.setdefault(chain_id, []).append(
                    rc.restype_3to1.get(resname, 'X'))
    return {k: ''.join(v) for k, v in seqs.items()}


def expand_to_seqres(chain: ChainData, seqres: str) -> ChainData:
    """Re-index an observed (ATOM-record) chain onto its SEQRES sequence.

    Residues missing density become coord_mask=0 rows at their true
    sequence positions, so downstream relative-position features and CDR
    annotation see the real chain — the reference handles this with a
    struct<->seq alignment (abx/preprocess/parser.py:77-135); here the
    observed sequence (an exact subsequence of SEQRES up to point
    mutations) is anchored with difflib matching blocks.
    """
    import difflib
    obs = chain.str_seq
    n = len(seqres)
    coords = np.zeros((n, 14, 3), dtype=np.float32)
    mask = np.zeros((n, 14), dtype=bool)
    resseq = [0] * n
    icodes = [' '] * n
    matcher = difflib.SequenceMatcher(a=seqres, b=obs, autojunk=False)
    placed = 0
    for a, b, size in matcher.get_matching_blocks():
        for k in range(size):
            coords[a + k] = chain.coords[b + k]
            mask[a + k] = chain.coord_mask[b + k]
            resseq[a + k] = chain.resseq[b + k]
            icodes[a + k] = chain.icodes[b + k]
            placed += 1
    if placed < 0.9 * len(obs):
        # SEQRES doesn't explain the observed chain (wrong chain id or a
        # heavily engineered construct): keep the observed-only view.
        return chain
    # Fill author numbering for unobserved rows by interpolation so residue
    # indices stay monotone.
    last = None
    for i in range(n):
        if mask[i].any():
            last = resseq[i]
        elif last is not None:
            last = last + 1
            resseq[i] = last
    nxt = None
    for i in range(n - 1, -1, -1):
        if mask[i].any():
            nxt = resseq[i]
        elif nxt is not None and resseq[i] == 0:
            nxt = nxt - 1
            resseq[i] = nxt
    return ChainData(chain_id=chain.chain_id, str_seq=seqres, coords=coords,
                     coord_mask=mask, resseq=resseq, icodes=icodes)


def _format_atom_line(serial, atom_name, resname, chain_id, resseq, xyz,
                      occupancy, bfactor, element):
    name_field = (f' {atom_name:<3s}' if len(atom_name) < 4 else atom_name)
    return (f'ATOM  {serial:>5d} {name_field}{"":1s}{resname:>3s} '
            f'{chain_id:1s}{resseq:>4d}{"":1s}   '
            f'{xyz[0]:>8.3f}{xyz[1]:>8.3f}{xyz[2]:>8.3f}'
            f'{occupancy:>6.2f}{bfactor:>6.2f}          '
            f'{element:>2s}\n')


def write_pdb_atoms(lines, str_seq, coords, chain_id, bfactors,
                    res_mask=None, serial_start=1, resseq_start=1):
    """Append atom14 records for one chain; returns the next serial number."""
    serial = serial_start
    if len(str_seq) == 0:
        return serial
    resname = 'UNK'
    for i, aa in enumerate(str_seq):
        if res_mask is not None and not res_mask[i]:
            continue
        resname = rc.restype_1to3.get(aa, 'UNK')
        names14 = rc.restype_name_to_atom14_names.get(resname, [''] * 14)
        for j, atom_name in enumerate(names14):
            if not atom_name:
                continue
            lines.append(_format_atom_line(
                serial, atom_name, resname, chain_id, resseq_start + i,
                coords[i, j], 1.0, float(bfactors[i]), atom_name[0]))
            serial += 1
    lines.append(f'TER   {serial:>5d}      {resname:>3s} '
                 f'{chain_id:1s}{resseq_start + len(str_seq) - 1:>4d}\n')
    return serial + 1


def save_complex_pdb(path: str, str_heavy_seq: str, heavy_chain: str,
                     str_light_seq: str, light_chain: str,
                     coords: np.ndarray, plddt: np.ndarray,
                     antigen_data: Optional[dict] = None):
    """Write designed antibody (+ cropped antigen context) to a PDB file.

    Parity surface: reference `save_pdb` (abx/data/utils.py:235-263): heavy
    and light chains carry per-residue pLDDT b-factors; antigen chains follow
    with chain ids from the complex name.
    """
    lines = ['REMARK   generated by abx_tpu\n']
    hl = len(str_heavy_seq)
    serial = write_pdb_atoms(lines, str_heavy_seq, coords[:hl], heavy_chain,
                             plddt[:hl])
    serial = write_pdb_atoms(lines, str_light_seq, coords[hl:],
                             light_chain, plddt[hl:hl + len(str_light_seq)],
                             serial_start=serial)

    if antigen_data is not None and len(antigen_data.get('antigen_str_seq',
                                                         '')) > 0:
        ag_seq = antigen_data['antigen_str_seq']
        ag_coords = np.asarray(antigen_data['antigen_coords'])
        ag_mask = np.asarray(antigen_data['antigen_coord_mask'])
        ag_chain_ids = np.asarray(antigen_data['antigen_chain_ids'])
        ag_chains = antigen_data['antigen_chains']
        start = 0
        for i, chain_name in enumerate(ag_chains):
            cid = i + 2
            chain_len = int(np.sum(ag_chain_ids == cid))
            if chain_len == 0:
                continue
            seq_i = ag_seq[start:start + chain_len]
            coords_i = ag_coords[start:start + chain_len]
            res_mask = ag_mask[start:start + chain_len,
                               rc.atom_order['CA']]
            bfac = np.full((chain_len,), float(plddt[0]))
            serial = write_pdb_atoms(lines, seq_i, coords_i, chain_name,
                                     bfac, res_mask=res_mask,
                                     serial_start=serial)
            start += chain_len
    lines.append('END\n')
    with open(path, 'w', encoding='utf-8') as f:
        f.writelines(lines)
