"""Single-complex CDR design CLI on one device.

Example (one H100):
    python -m abx_tpu_torch.cli.design --pdb_file testdata/6ct7_H_L_S.pdb \
        --output_dir out --num_samples 4 --batch_samples 4 --bf16

`--device` defaults to cuda and never falls back: without a card it
raises.  `--device cpu` must be asked for (with `--tiny` it is the CPU
smoke run).  Without `--model` the weights are random, from `--seed`.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from abx_tpu_torch.cli import runner


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('--pdb_file', type=str, required=True,
                   help='complex PDB named <code>_<H>_<L>_<AG[|AG2]>.pdb')
    p.add_argument('--output_dir', type=str, required=True)
    p.add_argument('--model', type=str, default=None,
                   help='flax msgpack checkpoint of the JAX package')
    p.add_argument('--model_config', type=str, default=None)
    p.add_argument('--num_samples', type=int, default=1)
    p.add_argument('--batch_samples', type=int, default=None)
    p.add_argument('--num_t', type=int, default=None)
    p.add_argument('--generate_area', type=str, default='H3')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--tiny', action='store_true',
                   help='tiny random model (smoke runs)')
    p.add_argument('--esm_checkpoint', type=str, default=None,
                   help='ESM2 weights (.pt fair-esm, or a msgpack of the '
                        'JAX package\'s ESM2 tree): conditions the trunk '
                        'on ESM2 embeddings')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 trunk compute')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)-15s [%(levelname)s] %(message)s')
    rt = runner.build_runtime(args.model_config, args.model, tiny=args.tiny,
                              seed=args.seed, bf16=args.bf16,
                              device=args.device,
                              esm_checkpoint=args.esm_checkpoint)
    complexes = runner.load_complexes(args.pdb_file, rt)
    return runner.run_sampling(
        rt, os.path.join(args.output_dir, 'design'), complexes,
        num_samples=args.num_samples, generate_area=args.generate_area,
        num_t=args.num_t, seed=args.seed, batch_samples=args.batch_samples)


if __name__ == '__main__':
    main()
