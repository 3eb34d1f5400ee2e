"""Training CLI, on one device or data-parallel over processes.

Counterpart of abx_tpu/cli/train.py: cluster-based sampling (one random
member per cluster per epoch, reference dataset.py:46-73), the train-mode
forward noising and the loss stack of `train/losses.py`, with the JAX
CLI's flags.  Training runs in f32, as the JAX CLI builds its runtime.

Data parallel: under an initialised process group (the caller's, or the
one this CLI joins from torchrun's environment, `--dist_backend` nccl with
one card a rank), the name list is sharded round-robin over the ranks,
each rank loads its `--batch_size / world` rows of the global batch and
its prefetch puts them on its own card, and the Trainer's step is the
one-process step on the global batch (train/trainer.py).  Rank 0 writes
the checkpoints and the metrics.  Example (one host, 4 cards):
    torchrun --nproc_per_node 4 -m abx_tpu_torch.cli.train \
        --dist_backend nccl --batch_size 16 --data_dir data/npz ...

Example (one H100):
    python -m abx_tpu_torch.cli.train --data_dir data/npz \
        --name_idx clusters.txt --is_cluster_idx --output_dir runs/exp1 \
        --num_steps 10000

On the CPU (tiny random model): add `--device cpu --tiny`.  The output
directory holds `params.pt` (the EMA weights: the inference checkpoint,
which `cli/design.py --model` and `cli/inference.py --model` take),
`params.pt.raw` (the raw weights), `params.pt.train` (the whole training
state, which `--resume` continues from) and `metrics.csv`.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist

from abx_tpu_torch.cli import runner
from abx_tpu_torch.data import dataset as ds
from abx_tpu_torch.parallel import mesh as mesh_lib
from abx_tpu_torch.train.trainer import TrainConfig, Trainer

logger = logging.getLogger(__name__)

CHECKPOINT = 'params.pt'


def parse_cluster_file(path: str) -> List[List[str]]:
    """Each line = whitespace-separated complex names forming one cluster."""
    clusters = []
    with open(path, encoding='utf-8') as f:
        for line in f:
            items = line.split()
            if items:
                clusters.append(items)
    return clusters


def batch_iterator(data_dir: str, names, cfg, batch_size: int,
                   is_cluster_idx: bool, seed: int,
                   reduce_num: int = 0) -> Iterator:
    """Infinite iterator of stacked static-shape numpy batches.

    Each epoch visits every cluster once in shuffled order and loads one
    random member; `reduce_num > 0` visits a per-epoch subset of that many
    clusters, shuffled with `random.Random(2022 + epoch)` (reference
    dataset.py:107-116).  Missing npz files and complexes without an
    interface are skipped."""
    rng = random.Random(seed)
    clusters = names if is_cluster_idx else [[n] for n in names]
    epoch = 0
    buffer = []
    while True:
        order = list(range(len(clusters)))
        if reduce_num and reduce_num > 0:
            random.Random(2022 + epoch).shuffle(order)
            order = order[:reduce_num]
        else:
            rng.shuffle(order)
        epoch += 1
        for ci in order:
            name = rng.choice(clusters[ci])
            path = os.path.join(data_dir, f'{name}.npz')
            if not os.path.exists(path):
                continue
            try:
                raw = ds.load_complex_npz(path, name)
                ex = ds._npz_to_example(raw)
                prep = ds.prepare_example(ex, cfg, is_training=True, rng=rng)
            except Exception as e:
                logger.warning('skip %s: %s', name, e)
                continue
            if prep is None:
                continue
            buffer.append(prep[0])
            if len(buffer) == batch_size:
                yield ds.stack_batch(buffer)
                buffer = []


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--name_idx', type=str, required=True)
    p.add_argument('--is_cluster_idx', action='store_true')
    p.add_argument('--output_dir', type=str, required=True)
    p.add_argument('--init_checkpoint', type=str, default=None,
                   help='starting weights (fine-tuning), told apart by '
                        'content: a reference checkpoint (the released '
                        'abx_diffab.ckpt / abx_rabd.ckpt), a weights file '
                        'of this trainer, or a flax msgpack of the JAX '
                        'package')
    p.add_argument('--model_config', type=str, default=None)
    p.add_argument('--batch_size', type=int, default=8)
    p.add_argument('--num_steps', type=int, default=10000,
                   help='the TOTAL number of steps: a resumed run makes '
                        'the remainder')
    p.add_argument('--learning_rate', type=float, default=1e-4)
    p.add_argument('--decay_steps', type=int, default=0,
                   help='cosine-decay the LR over this many steps after '
                        'warmup (0 = warmup-then-constant)')
    p.add_argument('--ema_decay', type=float, default=0.999,
                   help='EMA decay for the inference checkpoint (0 disables)')
    p.add_argument('--resume', action='store_true',
                   help='restore the full training state (optimizer '
                        'moments, step, EMA) from <output_dir>/'
                        f'{CHECKPOINT}.train if present')
    p.add_argument('--reduce_num', type=int, default=0,
                   help='per-epoch random subset size of clusters to visit '
                        '(reference dataset.py reduce_num; 0 = all)')
    p.add_argument('--prefetch', type=int, default=2,
                   help='batches built ahead by a background loader thread, '
                        'and moved to the device there (0 disables)')
    p.add_argument('--log_every', type=int, default=50)
    p.add_argument('--checkpoint_every', type=int, default=1000,
                   help='save the full train state every N steps (crash '
                        'resumability granularity)')
    p.add_argument('--use_orbax', action='store_true',
                   help='NOT SUPPORTED by the port: orbax checkpoints are '
                        'the JAX package\'s; the flag is refused')
    p.add_argument('--generate_area', type=str, default='cdr')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--esm_checkpoint', type=str, default=None,
                   help='frozen ESM2 conditioning during training (the '
                        "reference's configuration); fair-esm .pt checkpoint")
    p.add_argument('--esm_random', action='store_true',
                   help='frozen RANDOM-weight ESM2 conditioning (smoke/'
                        'perf studies when no checkpoint is available; '
                        'shape via --esm_layers/--esm_dim)')
    p.add_argument('--esm_layers', type=int, default=None)
    p.add_argument('--esm_dim', type=int, default=None)
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card; under "
                        "torchrun the card LOCAL_RANK names) or 'cpu'")
    p.add_argument('--dist_backend', type=str, default=None,
                   choices=['gloo', 'nccl'],
                   help='the process group\'s backend when this CLI joins '
                        'one from torchrun\'s environment (WORLD_SIZE > 1)')
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)
    if args.use_orbax:
        p.error('--use_orbax: orbax checkpoints are JAX-only; the port '
                f'writes {CHECKPOINT}{{,.raw,.train}} with torch.save')
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format='%(asctime)-15s [%(levelname)s] %(message)s')
    joined = False
    if not dist.is_initialized() and int(os.environ.get('WORLD_SIZE',
                                                        '1')) > 1:
        if args.dist_backend is None:
            p.error('WORLD_SIZE > 1: give --dist_backend (nccl with one '
                    'card a rank, gloo on the CPU)')
        dist.init_process_group(args.dist_backend, init_method='env://')
        joined = True
    try:
        return _train(args, p)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, p):
    device = args.device
    if (dist.is_initialized() and device == 'cuda'
            and 'LOCAL_RANK' in os.environ):
        device = f'cuda:{os.environ["LOCAL_RANK"]}'
    rt = runner.build_runtime(args.model_config, args.init_checkpoint,
                              tiny=args.tiny, seed=args.seed,
                              device=device,
                              esm_checkpoint=args.esm_checkpoint,
                              esm_random=args.esm_random,
                              esm_layers=args.esm_layers,
                              esm_dim=args.esm_dim)
    if args.is_cluster_idx:
        names = parse_cluster_file(args.name_idx)
    else:
        with open(args.name_idx, encoding='utf-8') as f:
            names = [x.strip() for x in f if x.strip()]
    mesh = (mesh_lib.make_mesh(device=rt.device) if dist.is_initialized()
            else mesh_lib.local_mesh(rt.device))
    if args.batch_size % mesh.size:
        p.error(f'--batch_size {args.batch_size} not divisible by the '
                f'{mesh.size} ranks')
    # Each rank loads its own rows of the global batch.
    names = ds.shard_names(names, mesh.rank, mesh.size)

    os.makedirs(args.output_dir, exist_ok=True)
    trainer = Trainer(
        rt.model, rt.diffuser, rt.config.model, rt.config.loss,
        TrainConfig(learning_rate=args.learning_rate,
                    decay_steps=args.decay_steps,
                    generate_area=args.generate_area,
                    ema_decay=args.ema_decay,
                    log_every=args.log_every,
                    checkpoint_every=args.checkpoint_every),
        esm=rt.esm, mesh=mesh)
    ckpt = os.path.join(args.output_dir, CHECKPOINT)
    if args.resume and os.path.exists(ckpt + '.train'):
        state = trainer.load_train_state(ckpt)
        logger.info('resumed full training state at step %d', state.step)
    else:
        state = trainer.init_state()
        if args.init_checkpoint:
            logger.warning(
                'starting from params only: optimizer moments, LR-schedule '
                'step and EMA are fresh (use --resume with a .train '
                'checkpoint to continue training exactly)')
    data_iter = batch_iterator(args.data_dir, names, rt.data_config,
                               args.batch_size // mesh.size,
                               args.is_cluster_idx,
                               args.seed, reduce_num=args.reduce_num)
    if args.prefetch > 0:
        from abx_tpu_torch.data.pipeline import prefetch
        data_iter = prefetch(data_iter, size=args.prefetch,
                             device_put_ahead=True, device=rt.device)
    remaining = max(args.num_steps - state.step, 0)
    if remaining < args.num_steps:
        logger.info('resuming at step %d: %d steps remain to the %d target',
                    state.step, remaining, args.num_steps)
    generator = torch.Generator(device=rt.device).manual_seed(args.seed)
    state = trainer.fit(state, data_iter, remaining, generator,
                        checkpoint_path=ckpt,
                        metrics_path=os.path.join(args.output_dir,
                                                  'metrics.csv'))
    if rt.device.type == 'cuda':
        logger.info('peak memory allocated: %.3f GB',
                    torch.cuda.max_memory_allocated(rt.device) / 1e9)
    return state


if __name__ == '__main__':
    main()
