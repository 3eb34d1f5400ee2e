"""Offline preprocessing: SAbDab structures -> per-complex .npz files.

The port's own copy of `abx_tpu/preprocess/make_data.py`, on the port's
numbering, pdb_io and mmcif modules.  Parity surface: the reference's
abx/preprocess/make_ab_data_from_mmcif.py —
SAbDab summary-TSV filtering (X-ray/EM, model 0, protein/peptide antigen),
per-chain atom14 features from mmCIF or PDB, IMGT renumbering + CDR labels,
variable-domain trim, chain merging (chain_id/residx offsets, antigen
cdr_def=14), multiprocess over complexes.

Output npz schema matches the reference exactly (antibody_*/antigen_* keys),
so datasets preprocessed by either implementation interoperate.

Numbering: `--numbering auto|anarci|template|abnum`, the backends of the
port's `preprocess/numbering.py` (ANARCI when installed, then the template
fit; AbNum only when asked for, as a remote lookup).  A chain that the
chosen backend cannot number drops its complex.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import parse_pdb
from abx_tpu_torch.preprocess.mmcif import parse_mmcif
from abx_tpu_torch.preprocess.numbering import BACKENDS, annotate_domain

logger = logging.getLogger(__name__)


def parse_sabdab_summary(path: str) -> List[Dict]:
    """Filter the SAbDab summary TSV (reference :21-46): model 0, X-ray/EM,
    protein/peptide antigen, paired H+L."""
    entries = []
    with open(path, encoding='utf-8') as f:
        header = f.readline().rstrip('\n').split('\t')
        col = {name: i for i, name in enumerate(header)}
        for line in f:
            items = line.rstrip('\n').split('\t')

            def get(name):
                i = col.get(name)
                return items[i] if i is not None and i < len(items) else ''

            if get('model') not in ('0', ''):
                continue
            method = get('method').upper()
            if not ('X-RAY' in method or 'ELECTRON MICROSCOPY' in method
                    or 'EM' == method):
                continue
            ag_type = get('antigen_type')
            if not ag_type or not any(
                    t in ag_type for t in ('protein', 'peptide')):
                continue
            heavy, light = get('Hchain'), get('Lchain')
            if not heavy or not light or heavy == 'NA' or light == 'NA':
                continue
            ag_chain = get('antigen_chain').replace(' ', '')
            if not ag_chain or ag_chain == 'NA':
                continue
            entries.append({
                'pdb': get('pdb'),
                'heavy': heavy,
                'light': light,
                'antigen': ag_chain.split('|'),
            })
    return entries


def make_complex_features(chains: Dict, heavy: str, light: str,
                          antigens: Sequence[str],
                          numbering_backend: str = 'auto'
                          ) -> Optional[Dict[str, np.ndarray]]:
    """Chain features -> merged antibody/antigen npz-schema arrays."""
    ab_parts, ag_parts = [], []
    for idx, (cid, tag) in enumerate([(heavy, 'H'), (light, 'L')]):
        if not cid or cid not in chains:
            return None
        data = chains[cid]
        ann = annotate_domain(data.str_seq, tag,
                              backend=numbering_backend)
        if ann is None:
            return None
        sl = slice(ann.start, ann.end)
        n = ann.end - ann.start
        ab_parts.append({
            'str_seq': data.str_seq[sl],
            'coords': data.coords[sl],
            'coord_mask': data.coord_mask[sl],
            'cdr_def': ann.cdr_def.astype(np.int32),
            'chain_id': np.full((n,), idx, np.int32),
            'residx': np.arange(n, dtype=np.int32)
            + (rc.residue_chain_index_offset if idx else 0),
        })
    for i, cid in enumerate(antigens):
        if not cid or cid not in chains:
            continue
        data = chains[cid]
        n = len(data.str_seq)
        if n == 0:
            continue
        ag_parts.append({
            'str_seq': data.str_seq,
            'coords': data.coords,
            'coord_mask': data.coord_mask,
            'cdr_def': np.full((n,), rc.antigen_cdr_index, np.int32),
            'chain_id': np.full((n,), i + 2, np.int32),
            'residx': np.arange(n, dtype=np.int32),
        })
    if not ag_parts:
        return None

    def merge(parts, prefix):
        return {
            f'{prefix}_str_seq': ''.join(p['str_seq'] for p in parts),
            f'{prefix}_coords': np.concatenate([p['coords'] for p in parts]),
            f'{prefix}_coord_mask': np.concatenate(
                [p['coord_mask'] for p in parts]),
            f'{prefix}_cdr_def': np.concatenate(
                [p['cdr_def'] for p in parts]),
            f'{prefix}_chain_ids': np.concatenate(
                [p['chain_id'] for p in parts]),
            f'{prefix}_residx': np.concatenate(
                [p['residx'] for p in parts]),
        }

    out = merge(ab_parts, 'antibody')
    out.update(merge(ag_parts, 'antigen'))
    return out


def process_entry(entry: Dict, struct_dir: str, output_dir: str,
                  numbering_backend: str = 'auto') -> Optional[str]:
    """Process one SAbDab complex into <code>_<H>_<L>_<AG>.npz."""
    code = entry['pdb']
    candidates = [
        os.path.join(struct_dir, f'{code}.cif'),
        os.path.join(struct_dir, f'{code}.cif.gz'),
        os.path.join(struct_dir, f'{code}.pdb'),
    ]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        logger.warning('%s: no structure file', code)
        return None
    try:
        chains = (parse_pdb(path) if path.endswith('.pdb')
                  else parse_mmcif(path))
        feats = make_complex_features(chains, entry['heavy'], entry['light'],
                                      entry['antigen'], numbering_backend)
        if feats is None:
            logger.warning('%s: feature construction failed', code)
            return None
        name = (f"{code}_{entry['heavy']}_{entry['light']}_"
                f"{'|'.join(entry['antigen'])}")
        out_path = os.path.join(output_dir, f'{name}.npz')
        np.savez(out_path, **feats)
        logger.info('wrote %s', out_path)
        return name
    except Exception as e:  # per-complex resilience (reference :318-324)
        logger.error('%s: %s', code, e)
        return None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--summary_file', type=str, required=True,
                   help='SAbDab summary TSV')
    p.add_argument('--struct_dir', type=str, required=True)
    p.add_argument('--output_dir', type=str, required=True)
    p.add_argument('--cpus', type=int, default=1)
    p.add_argument('--numbering', type=str, default='auto',
                   choices=list(BACKENDS))
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    os.makedirs(args.output_dir, exist_ok=True)
    entries = parse_sabdab_summary(args.summary_file)
    logger.info('%d complexes pass filters', len(entries))
    jobs = [(e, args.struct_dir, args.output_dir, args.numbering)
            for e in entries]
    if args.cpus > 1:
        with mp.get_context('spawn').Pool(args.cpus) as pool:
            names = pool.starmap(process_entry, jobs)
    else:
        names = [process_entry(*j) for j in jobs]
    names = [n for n in names if n]
    with open(os.path.join(args.output_dir, 'name_idx.txt'), 'w',
              encoding='utf-8') as f:
        f.write('\n'.join(names) + '\n')
    logger.info('done: %d/%d complexes', len(names), len(entries))


if __name__ == '__main__':
    main()
