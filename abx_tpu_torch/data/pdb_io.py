"""Minimal, dependency-free PDB reading/writing.

The port's own copy of the parts of `abx_tpu/data/pdb_io.py` that it calls:
`parse_pdb` (ATOM records of the first model, chains, insertion codes,
altlocs) and `save_complex_pdb` (AF2-style PDBs with pLDDT b-factors), with
the same names and output.  The SEQRES re-indexing helpers stay in the JAX
package: the port's runner does not use them.
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
