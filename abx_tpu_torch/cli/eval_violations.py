"""Structural-violation metrics over designed PDBs.

Counterpart of `abx_tpu/cli/eval_violations.py`.  Parity surface: the
reference's eval/metric_scripts/cal_vio.py — AF2 between-residue bond /
angle violations + clash checks repurposed as an eval, here computed with
`evaluation/relax.py::violation_energy` on `--device`:

    python -m abx_tpu_torch.cli.eval_violations --data_dir out/design

`--device` defaults to cuda and never falls back: without a card it
raises; `--device cpu` must be asked for.
"""

from __future__ import annotations

import argparse
import csv
import glob
import logging
import os

import numpy as np
import torch

from abx_tpu_torch.cli.runner import resolve_device
from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import parse_pdb
from abx_tpu_torch.evaluation.relax import violation_energy

logger = logging.getLogger(__name__)


def eval_one(pdb_file: str, device='cuda'):
    name = os.path.splitext(os.path.basename(pdb_file))[0]
    parts = name.split('_')
    wanted = parts[1:3] if len(parts) >= 3 else None
    chains = parse_pdb(pdb_file)
    seqs, coords, masks, residx = [], [], [], []
    offset = 0
    for cid, data in chains.items():
        if wanted and cid not in wanted:
            continue
        n = len(data.str_seq)
        seqs.append(data.str_seq)
        coords.append(data.coords)
        masks.append(data.coord_mask)
        residx.append(np.arange(n) + offset)
        offset += n + 512
    if not seqs:
        return None
    seq = rc.sequence_to_index(''.join(seqs))

    def on(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    with torch.no_grad():
        total, terms = violation_energy(
            on(np.concatenate(coords), torch.float32),
            on(seq, torch.long),
            on(np.concatenate(masks).astype(np.float32), torch.float32),
            on(np.concatenate(residx), torch.long))
    return {'name': name, 'file': pdb_file, 'total': float(total),
            'bond': float(terms['bond']), 'clash': float(terms['clash']),
            'within': float(terms['within'])}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--output_csv', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    files = [f for f in glob.glob(os.path.join(args.data_dir, '**', '*.pdb'),
                                  recursive=True) if 'reference' not in f]
    rows = [r for r in (eval_one(f, device) for f in files) if r]
    if not rows:
        logger.warning('no results')
        return
    csv_path = args.output_csv or os.path.join(args.data_dir,
                                               'violations.csv')
    with open(csv_path, 'w', newline='', encoding='utf-8') as f:
        w = csv.DictWriter(f, fieldnames=sorted(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"mean bond violation: {np.mean([r['bond'] for r in rows]):.4f}")
    print(f"mean clash violation: {np.mean([r['clash'] for r in rows]):.4f}")
    print(f"mean within-residue violation: "
          f"{np.mean([r['within'] for r in rows]):.4f}")
    print(f'wrote {csv_path}')


if __name__ == '__main__':
    main()
