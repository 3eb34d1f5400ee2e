"""Multi-complex training rehearsal: the whole training path in one run.

Counterpart of `tools/multi_train_rehearsal.py`.  Cluster sampling,
prefetch, mixed-complex static-shape batches, EMA and a checkpoint that a
killed run resumes from, composed:

  1. a 16-complex synthetic corpus: 8 variants of each bundled complex
     (6 CDR mutations and a 0-2 residue deletion inside one CDR each),
     made by the port's featurizer (`preprocess/make_data.py`), in 4
     clusters of 4 with one variant (`6ct7_v3`) held out of training;
  2. the training CLI (`python -m abx_tpu_torch.cli.train`) as a
     subprocess with `--is_cluster_idx --prefetch 2 --checkpoint_every`,
     killed with SIGKILL once the checkpoint at `--kill_frac` of the steps
     has landed;
  3. the same command with `--resume`, to the last step;
  4. the EMA weights sampled on the held-out variant (all six CDRs, bf16
     through the kernels).

Writes `metrics.csv` and `result.json` (the JAX tool's schema: corpus,
timeline, held-out evaluation; plus seconds a step from the metrics rows,
the resumed run's peak memory, the card) under `--out` (default
runs/multi_train_torch/); the corpus and checkpoints stay in `--work`.

    python -m abx_tpu_torch.tools.multi_train_rehearsal [--steps 300]
    python -m abx_tpu_torch.tools.multi_train_rehearsal --tiny --device cpu \\
        --steps 4 --checkpoint_every 2 --batch 1 --num_t 1 --num_samples 1 \\
        --out /tmp/mt

`--device` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import json
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from abx_tpu_torch.tools.overfit_6ct7 import MODEL_CONFIG, REPO, card_line

CDR_ENUMS = (1, 3, 5, 8, 10, 12)
AA = 'ARNDCQEGHILKMFPSTWYV'
PEAK_LINE = re.compile(r'peak memory allocated: ([0-9.]+) GB')


def make_variant(feats, rng, n_mut=6, max_del=2):
    """Perturb one complex's npz-schema features.

    Mutations replace CDR residue identities (side-chain coords masked out,
    the backbone stays physical); length jitter deletes up to `max_del`
    residues from inside one CDR loop (all antibody arrays sliced alike,
    residx keeps the gap like a real indel)."""
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in feats.items()}
    cdr = out['antibody_cdr_def']
    seq = list(out['antibody_str_seq'])

    cdr_pos = np.where(np.isin(cdr, CDR_ENUMS))[0]
    for p in rng.sample(list(cdr_pos), min(n_mut, len(cdr_pos))):
        old = seq[p]
        seq[p] = rng.choice([a for a in AA if a != old])
        out['antibody_coord_mask'][p, 4:] = False  # keep N/CA/C/O only

    n_del = rng.randrange(0, max_del + 1)
    if n_del:
        # Delete from the interior of one CDR (keeps anchors intact).
        loop = rng.choice(CDR_ENUMS)
        loop_pos = np.where(cdr == loop)[0]
        if len(loop_pos) > n_del + 2:
            start = rng.randrange(1, len(loop_pos) - n_del - 1)
            drop = loop_pos[start:start + n_del]
            keep = np.setdiff1d(np.arange(len(seq)), drop)
            seq = [seq[i] for i in keep]
            for k in ('antibody_coords', 'antibody_coord_mask',
                      'antibody_cdr_def', 'antibody_chain_ids',
                      'antibody_residx'):
                out[k] = out[k][keep]
    out['antibody_str_seq'] = ''.join(seq)
    return out


def build_corpus(corpus_dir, seed=0, per_parent=8):
    """16 variants (8 per bundled parent), 4 clusters, 1 held out.
    Returns (clusters.txt path, the held-out name, every name)."""
    from abx_tpu_torch.data.pdb_io import parse_pdb
    from abx_tpu_torch.preprocess.make_data import make_complex_features

    parents = [
        ('6ct7', 'testdata/6ct7_H_L_S.pdb', 'H', 'L', ['S']),
        ('6qd7', 'testdata/6qd7_X_Z_F|E.pdb', 'X', 'Z', ['F', 'E']),
    ]
    rng = random.Random(seed)
    os.makedirs(corpus_dir, exist_ok=True)
    clusters, names = [], []
    for code, pdb, h, l, ags in parents:
        feats = make_complex_features(
            parse_pdb(os.path.join(REPO, pdb)), h, l, ags)
        if feats is None:
            raise RuntimeError(f'{pdb}: the featurizer dropped the complex')
        variants = []
        for vi in range(per_parent):
            name = f'{code}_v{vi}'
            var = make_variant(feats, rng)
            np.savez(os.path.join(corpus_dir, f'{name}.npz'), **var)
            variants.append(name)
        names.extend(variants)
        # Two clusters of 4 per parent (as SAbDab sequence-identity
        # clusters: variants of one parent are near-identical sequences).
        clusters.append(variants[:per_parent // 2])
        clusters.append(variants[per_parent // 2:])
    holdout = clusters[0].pop()  # held out of training entirely
    cluster_path = os.path.join(corpus_dir, 'clusters.txt')
    with open(cluster_path, 'w', encoding='utf-8') as f:
        for c in clusters:
            f.write(' '.join(c) + '\n')
    return cluster_path, holdout, names


def logged_steps(metrics_path):
    """The steps of the metrics rows written so far."""
    if not os.path.exists(metrics_path):
        return []
    with open(metrics_path, newline='', encoding='utf-8') as f:
        return [int(float(r['step'])) for r in csv.DictReader(f)
                if r.get('step')]


def wait_for_checkpoint(proc, metrics_path, ckpt_train, step,
                        timeout=3600.0):
    """Block until the checkpoint of `step` has landed.  The trainer writes
    a step's metrics row, then its checkpoint, `.train` last
    (train/trainer.py::fit, ::save): so it has landed once `.train` is no
    older than the metrics file that ends with that step's row, or once a
    later row is written.  Returns the rows logged by then."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f'trainer exited early rc={proc.returncode}')
        steps = logged_steps(metrics_path)
        last = steps[-1] if steps else 0
        # Read after the rows: a row written in between makes it newer.
        row_time = os.path.getmtime(metrics_path) if steps else None
        if last > step or (last == step and os.path.exists(ckpt_train)
                           and os.path.getmtime(ckpt_train) >= row_time):
            return len(steps)
        time.sleep(0.5)
    raise TimeoutError(f'no checkpoint of step {step} within {timeout} s')


def now():
    return datetime.datetime.now().isoformat(timespec='seconds')


def peak_memory_gb(log_path):
    """The training CLI's last 'peak memory allocated' line, in GB."""
    with open(log_path, encoding='utf-8') as f:
        found = PEAK_LINE.findall(f.read())
    return float(found[-1]) if found else None


def holdout_eval(args, corpus_dir, train_dir, holdout):
    """The EMA weights' CDR designs of the held-out variant, bf16."""
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    rt = runner.build_runtime(None if args.tiny else MODEL_CONFIG,
                              os.path.join(train_dir, 'params.pt'),
                              tiny=args.tiny, seed=0, bf16=True,
                              device=args.device)
    raw = ds.load_complex_npz(os.path.join(corpus_dir, f'{holdout}.npz'),
                              holdout)
    feats, _ = ds.prepare_example(ds._npz_to_example(raw), rt.data_config)
    sfeats = to_device_batch(ds.stack_batch([feats] * args.num_samples),
                             rt.device)
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=args.num_t, mode='design',
                                    generate_area='cdr'), esm_fn=rt.esm)
    out = sampler.sample(sfeats,
                         torch.Generator(device=rt.device).manual_seed(1))
    mask = out['diffuse_mask'][0].float().cpu().numpy() > 0
    atom14 = out['atom14'].float().cpu().numpy()
    seq = out['seq'].cpu().numpy()
    gt_ca = np.asarray(feats['atom14_gt_positions'][:, 1])
    gt_seq = np.asarray(feats['seq'])
    rows = []
    for i in range(args.num_samples):
        rmsd = float(np.sqrt(np.mean(np.sum(
            (atom14[i, :, 1][mask] - gt_ca[mask]) ** 2, -1))))
        aar = float(np.mean(seq[i][mask] == gt_seq[mask]))
        rows.append({'sample': i, 'cdr_rmsd': rmsd, 'cdr_aar': aar})
        print(f'holdout {holdout} sample {i}: cdr_rmsd={rmsd:.3f} A '
              f'aar={aar:.3f}', flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--checkpoint_every', type=int, default=50)
    p.add_argument('--kill_frac', type=float, default=0.5,
                   help='SIGKILL once the checkpoint at this fraction of '
                        'the steps has landed')
    p.add_argument('--lr', type=float, default=5e-4)
    p.add_argument('--num_t', type=int, default=50)
    p.add_argument('--num_samples', type=int, default=4)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu', "
                        'for the training subprocesses and the evaluation')
    p.add_argument('--out', type=str,
                   default=os.path.join(REPO, 'runs', 'multi_train_torch'))
    p.add_argument('--work', type=str, default=os.path.join(
        tempfile.gettempdir(), 'abx_multi_train_torch'))
    args = p.parse_args(argv)

    from abx_tpu_torch.cli import runner
    device = runner.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    corpus_dir = os.path.join(args.work, 'corpus')
    timeline = [{'t': now(), 'event': 'corpus_build_start'}]
    cluster_path, holdout, names = build_corpus(corpus_dir, seed=args.seed)
    timeline.append({'t': now(), 'event': 'corpus_built',
                     'n_complexes': len(names), 'holdout': holdout})

    train_dir = os.path.join(args.work, 'train')
    if os.path.exists(train_dir):
        shutil.rmtree(train_dir)
    os.makedirs(train_dir)
    metrics_path = os.path.join(train_dir, 'metrics.csv')
    log_every = min(10, args.checkpoint_every)
    base_cmd = [
        sys.executable, '-m', 'abx_tpu_torch.cli.train',
        '--data_dir', corpus_dir, '--name_idx', cluster_path,
        '--is_cluster_idx', '--output_dir', train_dir,
        '--batch_size', str(args.batch), '--num_steps', str(args.steps),
        '--learning_rate', str(args.lr),
        '--decay_steps', str(max(args.steps - 100, 1)),
        '--checkpoint_every', str(args.checkpoint_every),
        '--prefetch', '2', '--log_every', str(log_every),
        '--seed', str(args.seed), '--device', args.device,
    ]
    # Run from the repository root: the model config by its relative path.
    base_cmd += ['--tiny'] if args.tiny else [
        '--model_config', os.path.relpath(MODEL_CONFIG, REPO)]

    # ---- 1: train, SIGKILL once the checkpoint at kill_frac has landed.
    kill_after = max(1, int(args.steps * args.kill_frac
                            / args.checkpoint_every)) * args.checkpoint_every
    timeline.append({'t': now(), 'event': 'train_start',
                     'cmd': ' '.join(['python'] + base_cmd[1:])})
    t_start = time.time()
    with open(os.path.join(train_dir, 'train.log'), 'w',
              encoding='utf-8') as log:
        proc = subprocess.Popen(base_cmd, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            rows = wait_for_checkpoint(
                proc, metrics_path,
                os.path.join(train_dir, 'params.pt.train'), kill_after)
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    timeline.append({'t': now(), 'event': 'sigkill',
                     'checkpoint_step': kill_after,
                     'after_metric_rows': rows,
                     'wall_s': round(time.time() - t_start, 1)})

    # ---- 2: resume to the last step.
    timeline.append({'t': now(), 'event': 'resume_start'})
    t_resume = time.time()
    resume_log = os.path.join(train_dir, 'resume.log')
    with open(resume_log, 'w', encoding='utf-8') as log:
        rc = subprocess.run(base_cmd + ['--resume'], cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(resume_log, encoding='utf-8') as f:
            sys.stderr.write(f.read()[-4000:])
        raise RuntimeError(f'resumed trainer failed rc={rc}')
    timeline.append({'t': now(), 'event': 'resume_done',
                     'wall_s': round(time.time() - t_resume, 1)})

    # ---- 3: EMA evaluation on the held-out variant.
    eval_rows = holdout_eval(args, corpus_dir, train_dir, holdout)
    timeline.append({'t': now(), 'event': 'holdout_eval_done'})

    shutil.copyfile(metrics_path, os.path.join(args.out, 'metrics.csv'))
    with open(metrics_path, newline='', encoding='utf-8') as f:
        metric_rows = list(csv.DictReader(f))
    rates = [float(r['steps_per_sec']) for r in metric_rows]
    result = {
        'corpus': {'n_complexes': len(names), 'clusters': 4,
                   'per_cluster': [4, 3, 4, 4], 'holdout': holdout,
                   'parents': ['6ct7_H_L_S', '6qd7_X_Z_F|E'],
                   'perturbation': '6 CDR mutations + 0-2 residue CDR '
                                   'deletion per variant'},
        'steps': args.steps, 'batch': args.batch,
        'checkpoint_every': args.checkpoint_every,
        'prefetch': 2, 'ema_decay': 0.999,
        'metric_rows': len(metric_rows),
        'last_step': int(float(metric_rows[-1]['step'])),
        # Each row's rate is over the log_every steps before it; the rows
        # after a process start include its first steps.
        's_per_step_median': float(np.median([1.0 / r for r in rates])),
        's_per_step_rows': [1.0 / r for r in rates],
        'peak_memory_gb_resumed_run': peak_memory_gb(resume_log),
        'timeline': timeline,
        'holdout_eval': {
            'generate_area': 'cdr', 'num_t': args.num_t, 'dtype': 'bf16',
            'cdr_rmsd_best': min(r['cdr_rmsd'] for r in eval_rows),
            'cdr_rmsd_mean': float(np.mean([r['cdr_rmsd']
                                            for r in eval_rows])),
            'cdr_aar_best': max(r['cdr_aar'] for r in eval_rows),
            'cdr_aar_mean': float(np.mean([r['cdr_aar']
                                           for r in eval_rows])),
            'samples': eval_rows,
        },
        'card': card_line(device),
        'tiny': args.tiny,
    }
    with open(os.path.join(args.out, 'result.json'), 'w',
              encoding='utf-8') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ('timeline', 's_per_step_rows')}))
    return result


if __name__ == '__main__':
    main()
