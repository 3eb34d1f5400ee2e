"""Minimal mmCIF structure parser (atom_site + poly_seq records).

The reference vendors AlphaFold's full mmCIF parser
(abx/data/mmcif_parsing.py) on top of BioPython; this parser, the port's
own copy of `abx_tpu/preprocess/mmcif.py`, needs neither and reads the
relevant loops directly:

  * `_atom_site` — coordinates (first model, altloc-filtered, author chains);
  * `_pdbx_poly_seq_scheme` — the full SEQRES-level sequence per chain, used
    to emit chains at full sequence length with missing residues masked
    (coord_mask = 0), matching the reference's seqres-aligned features
    (make_feature/seq2struc, make_ab_data_from_mmcif.py:75-105).  Falls back
    to observed-residues-only when the scheme loop is absent.
"""

from __future__ import annotations

import gzip
from typing import Dict, List

import numpy as np

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import ChainData


def _tokenize_cif_line(line: str) -> List[str]:
    """Split a CIF data line honouring single/double quotes."""
    out, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in ' \t':
            i += 1
        if i >= n:
            break
        if line[i] in '\'"':
            q = line[i]
            j = line.find(q, i + 1)
            if j == -1:
                j = n
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in ' \t':
                j += 1
            out.append(line[i:j])
            i = j
    return out


def _find_loops(lines, wanted):
    """Extract named loops: {category: (fields, rows)}."""
    out = {}
    i = 0
    while i < len(lines):
        if lines[i].strip() == 'loop_':
            j = i + 1
            hdr = []
            while j < len(lines) and lines[j].strip().startswith('_'):
                hdr.append(lines[j].strip().split('.')
                           if '.' in lines[j] else [lines[j].strip(), ''])
                j += 1
            cat = hdr[0][0] if hdr else None
            rows = []
            while j < len(lines):
                s = lines[j].strip()
                if (not s or s.startswith('#') or s.startswith('_')
                        or s == 'loop_' or s.startswith('data_')):
                    break
                rows.append(_tokenize_cif_line(s))
                j += 1
            if cat in wanted and cat not in out:
                out[cat] = ([h[1] for h in hdr], rows)
            i = j
        else:
            i += 1
    return out


def parse_mmcif(path: str) -> Dict[str, ChainData]:
    """Parse an mmCIF (optionally .gz) into per-chain atom14 ChainData."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt', encoding='utf-8', errors='replace') as f:
        lines = f.read().splitlines()

    loops = _find_loops(lines, {'_atom_site', '_pdbx_poly_seq_scheme'})
    if '_atom_site' not in loops:
        raise ValueError(f'no _atom_site loop in {path}')
    fields, rows = loops['_atom_site']
    col = {name: k for k, name in enumerate(fields)}

    def get(row, name, default=''):
        k = col.get(name)
        return row[k] if k is not None and k < len(row) else default

    chains: Dict[str, dict] = {}
    first_model = None
    for row in rows:
        if get(row, 'group_PDB') != 'ATOM':
            continue
        model_num = get(row, 'pdbx_PDB_model_num', '1')
        if first_model is None:
            first_model = model_num
        if model_num != first_model:
            continue
        altloc = get(row, 'label_alt_id', '.')
        if altloc not in ('.', '?', 'A'):
            continue
        resname = get(row, 'label_comp_id')
        if resname not in rc.restype_name_to_atom14_names:
            continue
        atom_name = get(row, 'label_atom_id').strip('"')
        chain_id = get(row, 'auth_asym_id') or get(row, 'label_asym_id')
        try:
            resseq = int(get(row, 'auth_seq_id') or get(row, 'label_seq_id'))
            x = float(get(row, 'Cartn_x'))
            y = float(get(row, 'Cartn_y'))
            z = float(get(row, 'Cartn_z'))
        except ValueError:
            continue
        icode = get(row, 'pdbx_PDB_ins_code', '?')
        icode = ' ' if icode in ('?', '.') else icode

        chain = chains.setdefault(chain_id, {'residues': {}, 'order': []})
        key = (resseq, icode)
        if key not in chain['residues']:
            chain['residues'][key] = {'resname': resname, 'atoms': {}}
            chain['order'].append(key)
        res = chain['residues'][key]
        if res['resname'] == resname:
            res['atoms'].setdefault(atom_name, (x, y, z))

    # SEQRES-level scheme: full per-chain sequence incl. missing residues.
    seqres = _parse_poly_seq_scheme(loops.get('_pdbx_poly_seq_scheme'))

    out: Dict[str, ChainData] = {}
    for chain_id, chain in chains.items():
        if chain_id in seqres:
            out[chain_id] = _chain_from_seqres(chain_id, chain,
                                               seqres[chain_id])
            continue
        keys = chain['order']
        n = len(keys)
        coords = np.zeros((n, 14, 3), dtype=np.float32)
        mask = np.zeros((n, 14), dtype=bool)
        seq_chars, resseqs, icodes = [], [], []
        for idx, key in enumerate(keys):
            res = chain['residues'][key]
            resname = res['resname']
            seq_chars.append(rc.restype_3to1.get(resname, 'X'))
            names14 = rc.restype_name_to_atom14_names[resname]
            for atom_name, xyz in res['atoms'].items():
                if atom_name in names14:
                    mask_idx = names14.index(atom_name)
                    coords[idx, mask_idx] = xyz
                    mask[idx, mask_idx] = True
            resseqs.append(key[0])
            icodes.append(key[1])
        out[chain_id] = ChainData(chain_id=chain_id,
                                  str_seq=''.join(seq_chars), coords=coords,
                                  coord_mask=mask, resseq=resseqs,
                                  icodes=icodes)
    return out


def _parse_poly_seq_scheme(loop):
    """_pdbx_poly_seq_scheme -> {auth_chain: [(mon_id, auth_seq, icode)]}."""
    if loop is None:
        return {}
    fields, rows = loop
    col = {name: k for k, name in enumerate(fields)}

    def get(row, name, default=''):
        k = col.get(name)
        return row[k] if k is not None and k < len(row) else default

    chains: Dict[str, list] = {}
    for row in rows:
        chain_id = get(row, 'pdb_strand_id') or get(row, 'asym_id')
        mon = get(row, 'mon_id')
        auth = get(row, 'pdb_seq_num')
        icode = get(row, 'pdb_ins_code', '.')
        icode = ' ' if icode in ('.', '?') else icode
        chains.setdefault(chain_id, []).append((mon, auth, icode))
    return chains


def _chain_from_seqres(chain_id, chain, scheme):
    """Full-length chain: SEQRES sequence, observed coords, missing masked."""
    entries = [(mon, auth, icode) for mon, auth, icode in scheme
               if mon in rc.restype_name_to_atom14_names]
    n = len(entries)
    coords = np.zeros((n, 14, 3), dtype=np.float32)
    mask = np.zeros((n, 14), dtype=bool)
    seq_chars, resseqs, icodes = [], [], []
    for i, (mon, auth, icode) in enumerate(entries):
        seq_chars.append(rc.restype_3to1.get(mon, 'X'))
        try:
            key = (int(auth), icode)
        except ValueError:
            key = None
        res = chain['residues'].get(key) if key else None
        if res is not None and res['resname'] == mon:
            names14 = rc.restype_name_to_atom14_names[mon]
            for atom_name, xyz in res['atoms'].items():
                if atom_name in names14:
                    j = names14.index(atom_name)
                    coords[i, j] = xyz
                    mask[i, j] = True
        resseqs.append(key[0] if key else -1)
        icodes.append(icode)
    return ChainData(chain_id=chain_id, str_seq=''.join(seq_chars),
                     coords=coords, coord_mask=mask, resseq=resseqs,
                     icodes=icodes)
