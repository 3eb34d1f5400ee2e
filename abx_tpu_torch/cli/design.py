"""Single-complex CDR design / optimize / trajectory CLI on one device.

Example (one H100):
    python -m abx_tpu_torch.cli.design --pdb_file testdata/6ct7_H_L_S.pdb \
        --output_dir out --num_samples 4 --batch_samples 4 --bf16

`--mode optimize --optimize_steps 4 8` re-noises the input complex to
t = k / num_t for each k and denoises it (outputs under OPT-<k>/);
`--mode trajectory` writes one `<name>@<t>.pdb` per step.  `--use_seqres`
re-indexes gappy chains onto the PDB's SEQRES records;
`--esm_reuse_recycles`, `--esm_refresh_every` and `--seq_corrector_steps`
are the sampler's opt-in, output-changing options.

`--device` defaults to cuda and never falls back: without a card it
raises.  `--device cpu` must be asked for (with `--tiny` it is the CPU
smoke run).  Without `--model` the weights are random, from `--seed`;
`--model abx_diffab.ckpt` runs the released weights.
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
    p.add_argument('--mode', type=str, default='design',
                   choices=['design', 'optimize', 'trajectory'])
    p.add_argument('--model', type=str, default=None,
                   help='trunk weights, told apart by content: a reference '
                        'checkpoint (the released abx_diffab.ckpt / '
                        'abx_rabd.ckpt), the weights file the port\'s '
                        'trainer writes (cli/train.py: params.pt), or a '
                        'flax msgpack checkpoint of the JAX package')
    p.add_argument('--model_config', type=str, default=None)
    p.add_argument('--num_samples', type=int, default=1)
    p.add_argument('--batch_samples', type=int, default=None)
    p.add_argument('--num_t', type=int, default=None)
    p.add_argument('--generate_area', type=str, default='H3')
    p.add_argument('--optimize_steps', type=int, nargs='+',
                   default=[4, 8, 16, 32, 64])
    p.add_argument('--use_seqres', action='store_true',
                   help='re-index chains onto SEQRES records so missing-'
                        'density residues keep their true positions')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--tiny', action='store_true',
                   help='tiny random model (smoke runs)')
    p.add_argument('--resume', action='store_true',
                   help='skip samples whose output PDB already exists')
    p.add_argument('--esm_checkpoint', type=str, default=None,
                   help='ESM2 weights (.pt fair-esm, or a msgpack of the '
                        'JAX package\'s ESM2 tree): conditions the trunk '
                        'on ESM2 embeddings')
    p.add_argument('--esm_reuse_recycles', action='store_true',
                   help='OPT-IN, output-changing: one ESM pass per diffusion '
                        'step, reused across recycle passes (~3x less ESM '
                        'compute; quality eval in docs/ESM.md)')
    p.add_argument('--esm_refresh_every', type=int, default=1,
                   help='OPT-IN, output-changing, needs --esm_reuse_recycles:'
                        ' refresh the cached ESM embedding every k steps '
                        '(further ~k x less ESM compute; docs/ESM.md)')
    p.add_argument('--seq_corrector_steps', type=int, default=0,
                   help='OPT-IN, output-changing: k Gibbs-corrector jumps '
                        'on the sequence track after each predictor step '
                        '(repairs tau-leaping error at reduced --num_t; '
                        'docs/SAMPLING.md)')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 trunk compute')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)-15s [%(levelname)s] %(message)s')
    rt = runner.build_runtime(args.model_config, args.model, tiny=args.tiny,
                              seed=args.seed, bf16=args.bf16,
                              device=args.device,
                              esm_checkpoint=args.esm_checkpoint)
    complexes = runner.load_complexes(None, None, args.pdb_file, rt,
                                      use_seqres=args.use_seqres)
    return runner.run_sampling(
        rt, os.path.join(args.output_dir, args.mode), complexes,
        num_samples=args.num_samples, generate_area=args.generate_area,
        num_t=args.num_t, seed=args.seed, batch_samples=args.batch_samples,
        mode=args.mode, opt_steps=args.optimize_steps, resume=args.resume,
        esm_reuse_recycles=args.esm_reuse_recycles,
        esm_refresh_every=args.esm_refresh_every,
        seq_corrector_steps=args.seq_corrector_steps)


if __name__ == '__main__':
    main()
