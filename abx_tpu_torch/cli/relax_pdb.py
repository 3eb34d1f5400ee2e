"""Batch relax of designed PDBs (reference relax_pdb.py equivalent).

Counterpart of `abx_tpu/cli/relax_pdb.py`: relaxes the CDR regions of
every PDB under --data_dir, writing `<name>_relaxed.pdb` alongside (or to
--output_dir), with the gradient relaxer of `evaluation/relax.py` on
`--device`:

    python -m abx_tpu_torch.cli.relax_pdb --data_dir out/design

`--device` defaults to cuda and never falls back: without a card it
raises; `--device cpu` must be asked for.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Optional

import numpy as np

from abx_tpu_torch.cli.runner import resolve_device
from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import parse_pdb, save_complex_pdb
from abx_tpu_torch.evaluation.relax import gradient_relax
from abx_tpu_torch.preprocess.numbering import annotate_domain

logger = logging.getLogger(__name__)


def relax_one(pdb_file: str, output_file: str,
              device='cuda') -> Optional[dict]:
    """Relax one complex; returns the relaxer's metrics (energy, bond and
    clash before / after), or None when the antibody chains are missing."""
    name = os.path.splitext(os.path.basename(pdb_file))[0]
    parts = name.split('_')
    heavy_id, light_id = (parts[1], parts[2]) if len(parts) >= 3 \
        else ('H', 'L')
    antigen_ids = parts[3].split('|') if len(parts) > 3 else []
    chains = parse_pdb(pdb_file)
    if heavy_id not in chains or light_id not in chains:
        logger.warning('%s: missing antibody chains', pdb_file)
        return None

    # Antibody chains (CDRs movable) + antigen chains (fixed context) all
    # enter the energy so CDRs cannot be minimised into the antigen.
    seqs, coords, masks, move, resseq = [], [], [], [], []
    offset = 0
    for cid, tag in ((heavy_id, 'H'), (light_id, 'L')):
        data = chains[cid]
        ann = annotate_domain(data.str_seq, tag)
        n = len(data.str_seq)
        cdr_mask = np.zeros((n,), np.float32)
        if ann is not None:
            region = np.full((n,), -1, np.int32)
            region[ann.start:ann.end] = ann.cdr_def
            cdr_enums = set(rc.cdr_str_to_enum.values())
            cdr_mask = np.isin(region, list(cdr_enums)).astype(np.float32)
        seqs.append(data.str_seq)
        coords.append(data.coords)
        masks.append(data.coord_mask)
        move.append(cdr_mask)
        resseq.append(np.arange(n) + offset)
        offset += n + 512
    ag_data = []
    for cid in antigen_ids:
        if cid not in chains:
            continue
        data = chains[cid]
        n = len(data.str_seq)
        ag_data.append(data)
        seqs.append(data.str_seq)
        coords.append(data.coords)
        masks.append(data.coord_mask)
        move.append(np.zeros((n,), np.float32))
        resseq.append(np.arange(n) + offset)
        offset += n + 512

    seq_idx = rc.sequence_to_index(''.join(seqs))
    atom14 = np.concatenate(coords)
    exists = np.concatenate(masks).astype(np.float32)
    move_mask = np.concatenate(move)
    residx = np.concatenate(resseq)

    relaxed, metrics = gradient_relax(atom14, seq_idx, exists, residx,
                                      move_mask, device=device)
    logger.info('%s: energy %.4f -> %.4f (clash %.4f -> %.4f)',
                name, metrics['energy_before'], metrics['energy_after'],
                metrics['clash_before'], metrics['clash_after'])

    h_len, l_len = len(seqs[0]), len(seqs[1])
    ab_len = h_len + l_len
    plddt = np.full((ab_len,), 99.0)
    antigen_data = None
    if ag_data:
        antigen_data = {
            'antigen_str_seq': ''.join(d.str_seq for d in ag_data),
            'antigen_coords': np.concatenate(
                [d.coords for d in ag_data]),
            'antigen_coord_mask': np.concatenate(
                [d.coord_mask for d in ag_data]),
            'antigen_chain_ids': np.concatenate(
                [np.full((len(d.str_seq),), i + 2)
                 for i, d in enumerate(ag_data)]),
            'antigen_chains': [d.chain_id for d in ag_data],
        }
    save_complex_pdb(output_file, seqs[0], heavy_id, seqs[1], light_id,
                     relaxed[:ab_len], plddt, antigen_data)
    return metrics


def main(argv=None):
    """Returns {input PDB: the relaxer's metrics} of the relaxed files."""
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    device = resolve_device(args.device)

    files = [f for f in glob.glob(
        os.path.join(args.data_dir, '**', '*.pdb'), recursive=True)
        if 'reference' not in f and '_relaxed' not in f]
    out_dir = args.output_dir or args.data_dir
    done = {}
    for f in files:
        # Mirror the sample-subdirectory layout (out/0000/name.pdb, ...) so
        # same-named samples from different subdirs don't overwrite each
        # other in a flat output directory.
        rel = os.path.relpath(f, args.data_dir)
        name = os.path.splitext(os.path.basename(rel))[0]
        sub = os.path.join(out_dir, os.path.dirname(rel))
        os.makedirs(sub, exist_ok=True)
        out = os.path.join(sub, f'{name}_relaxed.pdb')
        metrics = relax_one(f, out, device)
        if metrics:
            done[f] = metrics
    logger.info('relaxed %d/%d', len(done), len(files))
    return done


if __name__ == '__main__':
    main()
