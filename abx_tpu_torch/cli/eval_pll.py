"""Sequence plausibility (masked pseudo-log-likelihood) over designed PDBs.

Counterpart of `abx_tpu/cli/eval_pll.py`.  Parity surface: the reference's
eval/metric_scripts/calculate_pll.py (AntiBERTy pLL) — computed here with
an ESM2-family model in f32 from a fair-esm `.pt` (`--esm_checkpoint`),
which must hold the LM head; one row per antibody chain:

    python -m abx_tpu_torch.cli.eval_pll --data_dir out/design \
        --esm_checkpoint esm2_t36_3B_UR50D.pt

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
from abx_tpu_torch.data.pdb_io import parse_pdb

logger = logging.getLogger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--esm_checkpoint', type=str, required=True)
    p.add_argument('--num_layers', type=int, default=36)
    p.add_argument('--embed_dim', type=int, default=2560)
    p.add_argument('--num_heads', type=int, default=None,
                   help='override the released-size head-count table')
    p.add_argument('--output_csv', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    from abx_tpu_torch.evaluation.pll import masked_pll
    from abx_tpu_torch.models.esm import (ESM2, ESM2Config, ESM2LMHead,
                                          esm2_num_heads)
    from abx_tpu_torch.utils import params as params_lib

    cfg = ESM2Config(num_layers=args.num_layers, embed_dim=args.embed_dim,
                     attention_heads=esm2_num_heads(args.embed_dim,
                                                    override=args.num_heads))
    state = params_lib.fair_esm_state_dict(args.esm_checkpoint)
    if not params_lib.has_lm_head(state):
        raise SystemExit('checkpoint has no lm_head weights; PLL needs the '
                         'full masked-LM checkpoint')
    dtype = torch.float32
    esm_model = ESM2(cfg, dtype=dtype, device='meta')
    params_lib.load_esm_params(esm_model, state, device, dtype)
    lm_head = ESM2LMHead(cfg, dtype=dtype, device='meta')
    params_lib.load_lm_head_params(lm_head, state, device, dtype)
    del state
    esm_model.eval()
    lm_head.eval()
    embed_weight = esm_model.embed_tokens.weight

    def lm_head_fn(features):
        return lm_head(features, embed_weight)

    rows = []
    for f in sorted(glob.glob(os.path.join(args.data_dir, '**', '*.pdb'),
                              recursive=True)):
        if 'reference' in f:
            continue
        name = os.path.splitext(os.path.basename(f))[0]
        parts = name.split('_')
        ab_chains = parts[1:3] if len(parts) >= 3 else ['H', 'L']
        chains = parse_pdb(f)
        for cid in ab_chains:
            if cid not in chains:
                continue
            pll = masked_pll(esm_model, lm_head_fn, chains[cid].str_seq)
            rows.append({'name': name, 'chain': cid, 'pll': pll, 'file': f})
            logger.info('%s %s: pll=%.4f', name, cid, pll)
    if rows:
        csv_path = args.output_csv or os.path.join(args.data_dir, 'pll.csv')
        with open(csv_path, 'w', newline='', encoding='utf-8') as fh:
            w = csv.DictWriter(fh, fieldnames=sorted(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"mean pll: {np.mean([r['pll'] for r in rows]):.4f}; "
              f"wrote {csv_path}")
    return rows


if __name__ == '__main__':
    main()
