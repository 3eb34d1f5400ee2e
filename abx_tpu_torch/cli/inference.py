"""Test-set design / optimize / trajectory CLI (reference inference.py).

Iterates a name index over a directory of per-complex npz files (the
reference preprocessing schema; `data/dataset.py::complex_from_pdb` writes
it from a PDB) and writes the designed PDBs of each sample under
`<output_dir>/<mode>/`.

Example (one H100), CDR-H3 optimization of every complex of a test set at
two re-noising strengths:
    python -m abx_tpu_torch.cli.inference --data_dir test_npz \\
        --name_idx test_npz/names.txt --output_dir out --mode optimize \\
        --optimize_steps 4 8 --num_samples 4 --batch_samples 4 --bf16 \\
        --model_config config/config_model.json

`--esm_reuse_recycles`, `--esm_refresh_every` and `--seq_corrector_steps`
are the sampler's opt-in, output-changing options.

Multi-host: `--coordinator host:port --num_hosts N --host_id i` on each
of N processes (one card each, e.g. `--device cuda:i` on one machine)
joins a `tcp://` gloo process group (the hosts exchange nothing but a
barrier at the end) and shards the name list
round-robin over the processes (`data/dataset.py::shard_names`); each
process samples its complexes on its own card.

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

import torch.distributed as dist

from abx_tpu_torch.cli import runner
from abx_tpu_torch.data.dataset import shard_names
from abx_tpu_torch.parallel import mesh as mesh_lib


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True,
                   help='directory of <name>.npz complexes')
    p.add_argument('--name_idx', type=str, required=True,
                   help='file with one complex name per line')
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
    p.add_argument('--num_samples', type=int, default=100)
    p.add_argument('--num_t', type=int, default=None)
    p.add_argument('--generate_area', type=str, default='H3')
    p.add_argument('--optimize_steps', type=int, nargs='+',
                   default=[4, 8, 16, 32, 64])
    p.add_argument('--batch_samples', type=int, default=None)
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
                   help="'cuda' (default; raises without a card), 'cuda:<i>' "
                        "or 'cpu'")
    p.add_argument('--coordinator', type=str, default=None,
                   help='multi-host: host:port of process 0 (a tcp:// '
                        'process group); requires --num_hosts/--host_id')
    p.add_argument('--num_hosts', type=int, default=None)
    p.add_argument('--host_id', type=int, default=None)
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)
    if args.coordinator and (args.num_hosts is None or args.host_id is None):
        p.error('--coordinator requires --num_hosts and --host_id')

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)-15s [%(levelname)s] %(message)s')
    with open(args.name_idx, encoding='utf-8') as f:
        name_idx = [x.strip() for x in f if x.strip()]
    if args.coordinator:
        # gloo: the hosts exchange nothing but the final barrier.
        mesh_lib.init_process_group('gloo', args.coordinator,
                                    args.num_hosts, args.host_id)
        # Complexes over hosts; each host samples its own on its device.
        name_idx = shard_names(name_idx, dist.get_rank(),
                               dist.get_world_size())
    try:
        log = _run(args, name_idx)
        if args.coordinator:
            dist.barrier()  # no host leaves while another still samples
        return log
    finally:
        if args.coordinator:
            dist.destroy_process_group()


def _run(args, name_idx):
    rt = runner.build_runtime(args.model_config, args.model, tiny=args.tiny,
                              seed=args.seed, bf16=args.bf16,
                              device=args.device,
                              esm_checkpoint=args.esm_checkpoint)
    complexes = runner.load_complexes(args.data_dir, name_idx, None, rt)
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
