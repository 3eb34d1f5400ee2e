"""Trainer validation: overfit the flagship model on one complex (6ct7).

Counterpart of `tools/overfit_6ct7.py`: train the model of
`config/config_model.json` (ESM off unless `--esm_random`; f32, train()
mode, so the plain route) on `testdata/6ct7_H_L_S.pdb` alone, with the JAX
tool's defaults (2,500 steps of batch 2, lr 5e-4 after 100 warm-up steps
with cosine decay, EMA 0.999, H3 design), then sample H3 with the EMA
weights on the training complex: `--num_samples` samples in chunks of 4,
once in f32 and once in bf16 through the default kernel route, with the
same seeds (1 + the chunk's first sample).  Per sample: the H3 CA RMSD
(unaligned: the framework stays in place) and the amino-acid recovery,
with the mean +- 95% CI of each as the JAX tool's `summarize` computes
them, and the bf16 - f32 difference of each sample.

Writes `metrics.csv` (the training curve) and `result.json` under `--out`
(default runs/overfit_6ct7_torch/), and the EMA weights `params.pt`
(plus `.raw`, `.train`), which git ignores.

    python -m abx_tpu_torch.tools.overfit_6ct7 [--steps 2500] [--batch 2]
    python -m abx_tpu_torch.tools.overfit_6ct7 --tiny --steps 2 \\
        --num_t 2 --num_samples 1 --device cpu --out /tmp/overfit

`--device` defaults to cuda and raises without a card.  `--deadline_s`
stops training at a step boundary once that many seconds have passed (the
schedule stays the one of `--steps`; `result.json` records the steps
made).  `--eval_only` samples from `<out>/params.pt` of an earlier run.

The JAX tool's quality studies of the sampler's output-changing options:
`--eval_esm_reuse`, `--eval_esm_refresh K...`, `--eval_corrector NUM_T...`
and `--eval_fast_recipe` evaluate the same weights again with those
`SamplerConfig` options, in both dtypes, under the JAX tool's result keys
(`esm_reuse`, `esm_refresh_k{k}`, `corrector_t{nt}_off` / `_k2`,
`fast_recipe_t25`; each `{'f32': summary, 'bf16': summary}`);
`--exact_elbo` trains the sequence loss with the exact tau-leaping ELBO.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PDB = os.path.join(REPO, 'testdata', '6ct7_H_L_S.pdb')
MODEL_CONFIG = os.path.join(REPO, 'config', 'config_model.json')
EVAL_CHUNK = 4
LOG_EVERY = 50
# The bench's fast_recipe_t25: num_t 25, two corrector jumps a step, ESM
# reuse refreshed every 8 grid positions.
FAST_RECIPE = {'esm_reuse': True, 'refresh_every': 8, 'num_t': 25,
               'corrector_steps': 2}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != 'cuda':
        return 'cpu'
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def summarize(rows):
    """Mean +- 95% CI of the per-sample H3 RMSD and AAR (the JAX tool's
    `summarize`)."""
    rmsds = np.asarray([r['h3_rmsd'] for r in rows])
    aars = np.asarray([r['h3_aar'] for r in rows])
    n = len(rows)
    ci = 1.96 / np.sqrt(n) if n > 1 else float('nan')
    return {
        'n': n,
        'h3_rmsd_best': float(rmsds.min()),
        'h3_rmsd_mean': float(rmsds.mean()),
        'h3_rmsd_ci95': float(rmsds.std(ddof=1) * ci) if n > 1 else None,
        'h3_aar_best': float(aars.max()),
        'h3_aar_mean': float(aars.mean()),
        'h3_aar_ci95': float(aars.std(ddof=1) * ci) if n > 1 else None,
        'samples': rows,
    }


def complex_features(rt):
    """The training complex, prepared as the design CLI prepares it."""
    from abx_tpu_torch.cli import runner
    feats, _ = next(runner.load_complexes(None, None, PDB, rt))
    return feats


def train(args, out: str, device: str) -> dict:
    """Train, write metrics.csv and the EMA weights (params.pt); return the
    training record."""
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.train.trainer import TrainConfig, Trainer

    rt = runner.build_runtime(None if args.tiny else MODEL_CONFIG,
                              tiny=args.tiny, seed=0, device=device,
                              esm_random=args.esm_random,
                              esm_layers=args.esm_layers,
                              esm_dim=args.esm_dim)
    if args.exact_elbo:
        rt.config.loss.diffusion_seq.config.exact_elbo = True
    batch = ds.stack_batch([complex_features(rt)] * args.batch)
    trainer = Trainer(
        rt.model, rt.diffuser, rt.config.model, rt.config.loss,
        TrainConfig(learning_rate=args.lr, warmup_steps=100,
                    decay_steps=max(args.steps - 100, 1),
                    generate_area=args.generate_area,
                    log_every=min(LOG_EVERY, args.steps), ema_decay=0.999,
                    checkpoint_every=0),
        esm=rt.esm)
    metrics = os.path.join(out, 'metrics.csv')
    if os.path.exists(metrics):
        os.remove(metrics)      # a new run: fit appends under a header
    state = trainer.init_state()
    generator = torch.Generator(device=rt.device).manual_seed(0)
    chunk = min(LOG_EVERY, args.steps)
    t0 = time.time()
    while state.step < args.steps:
        n = min(chunk, args.steps - state.step)
        # A fresh iterator each chunk: fit closes the one it was given.
        trainer.fit(state, iter(lambda: dict(batch), None), n, generator,
                    metrics_path=metrics)
        if args.deadline_s and time.time() - t0 > args.deadline_s:
            break
    if rt.device.type == 'cuda':
        torch.cuda.synchronize()
    seconds = time.time() - t0
    trainer.save(os.path.join(out, 'params.pt'), state)
    with open(metrics, newline='', encoding='utf-8') as f:
        rows = list(csv.DictReader(f))
    record = {'steps': state.step, 'steps_requested': args.steps,
              'train_seconds': seconds,
              'steps_per_second': state.step / seconds,
              'peak_memory_gb': (torch.cuda.max_memory_allocated(rt.device)
                                 / 1e9 if rt.device.type == 'cuda' else None)}
    if rows:
        record['loss_first'] = {k: float(rows[0][k]) for k in
                                ('step', 'total') if rows[0].get(k)}
        record['loss_last'] = {k: float(rows[-1][k]) for k in
                               ('step', 'total') if rows[-1].get(k)}
    del trainer, state, rt
    if device.startswith('cuda'):
        torch.cuda.empty_cache()
    return record


def eval_runtime(args, out: str, device: str, bf16: bool):
    """The EMA weights of `<out>/params.pt` in one dtype."""
    from abx_tpu_torch.cli import runner
    return runner.build_runtime(None if args.tiny else MODEL_CONFIG,
                                os.path.join(out, 'params.pt'),
                                tiny=args.tiny, seed=0, bf16=bf16,
                                device=device, esm_random=args.esm_random,
                                esm_layers=args.esm_layers,
                                esm_dim=args.esm_dim)


def evaluate(args, rt, num_t=None, esm_reuse=False, refresh_every=1,
             corrector_steps=0):
    """Sample the generate area on runtime `rt` (`eval_runtime`), with the
    sampler options of the JAX tool's `eval_samples`; one row per sample,
    and the seconds it took."""
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    feats = complex_features(rt)
    chunk = min(args.num_samples, EVAL_CHUNK)
    sfeats = to_device_batch(ds.stack_batch([feats] * chunk), rt.device)
    gt_ca = np.asarray(feats['atom14_gt_positions'][:, 1])
    gt_seq = np.asarray(feats['seq'])
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=num_t or args.num_t, mode='design',
                                    generate_area=args.generate_area,
                                    esm_reuse_recycles=esm_reuse,
                                    esm_refresh_every=refresh_every,
                                    seq_corrector_steps=corrector_steps),
                      esm_fn=rt.esm)
    dtype = 'bf16' if rt.model.dtype == torch.bfloat16 else 'f32'
    tag = ('  [esm_reuse]' if esm_reuse else '') + (
        f'  [refresh_k={refresh_every}]' if refresh_every > 1 else '') + (
        f'  [num_t={num_t}]' if num_t else '') + (
        f'  [corrector_k={corrector_steps}]' if corrector_steps else '')
    rows = []
    t0 = time.time()
    for c0 in range(0, args.num_samples, chunk):
        g = torch.Generator(device=rt.device).manual_seed(1 + c0)
        res = sampler.sample(sfeats, g)
        mask = res['diffuse_mask'][0].float().cpu().numpy() > 0
        atom14 = res['atom14'].float().cpu().numpy()
        seq = res['seq'].cpu().numpy()
        for j in range(min(chunk, args.num_samples - c0)):
            pred_ca = atom14[j, :, 1]
            # Framework fixed in place -> direct (unaligned) RMSD.
            rmsd = float(np.sqrt(np.mean(np.sum(
                (pred_ca[mask] - gt_ca[mask]) ** 2, -1))))
            aar = float(np.mean(seq[j][mask] == gt_seq[mask]))
            rows.append({'sample': c0 + j, 'h3_rmsd': rmsd, 'h3_aar': aar})
            print(f'sample {c0 + j} ({dtype}): {args.generate_area} '
                  f'rmsd={rmsd:.3f} A aar={aar:.3f}' + tag, flush=True)
    return rows, time.time() - t0


def eval_configs(args):
    """(result key, `evaluate` options) of each `--eval_*` flag, under the
    JAX tool's keys."""
    out = []
    if args.eval_esm_reuse:
        out.append(('esm_reuse', {'esm_reuse': True}))
    for k in args.eval_esm_refresh:
        out.append((f'esm_refresh_k{k}',
                    {'esm_reuse': True, 'refresh_every': k}))
    for nt in args.eval_corrector:
        out.append((f'corrector_t{nt}_off',
                    {'num_t': nt, 'corrector_steps': 0}))
        out.append((f'corrector_t{nt}_k2',
                    {'num_t': nt, 'corrector_steps': 2}))
    if args.eval_fast_recipe:
        out.append(('fast_recipe_t25', FAST_RECIPE))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=2500)
    p.add_argument('--batch', type=int, default=2)
    p.add_argument('--num_samples', type=int, default=4)
    p.add_argument('--num_t', type=int, default=50)
    p.add_argument('--lr', type=float, default=5e-4)
    p.add_argument('--generate_area', type=str, default='H3',
                   help="'H3' or 'cdr' (all six CDRs co-design)")
    p.add_argument('--tiny', action='store_true')
    p.add_argument('--esm_random', action='store_true',
                   help='condition on a frozen random-weight ESM2 encoder '
                        '(no real weights in the repository); shape via '
                        '--esm_layers/--esm_dim')
    p.add_argument('--esm_layers', type=int, default=6)
    p.add_argument('--esm_dim', type=int, default=320)
    p.add_argument('--exact_elbo', action='store_true',
                   help='train the sequence loss with the exact tau-leaping '
                        'CTMC ELBO instead of the CE surrogate')
    p.add_argument('--eval_esm_reuse', action='store_true',
                   help='also evaluate with esm_reuse_recycles on')
    p.add_argument('--eval_esm_refresh', type=int, nargs='*', default=[],
                   help='also evaluate esm_refresh_every at these k values '
                        '(each with esm_reuse_recycles)')
    p.add_argument('--eval_corrector', type=int, nargs='*', default=[],
                   help='also evaluate at these reduced num_t values, the '
                        'sequence corrector off and at k=2 for each')
    p.add_argument('--eval_fast_recipe', action='store_true',
                   help="also evaluate the bench's fast_recipe_t25 (num_t "
                        '25, corrector k=2, ESM reuse refreshed every 8)')
    p.add_argument('--eval_only', action='store_true',
                   help='skip training; sample from <out>/params.pt (the '
                        'EMA weights of an earlier run)')
    p.add_argument('--deadline_s', type=float, default=0.0,
                   help='stop training after this many seconds (0: none)')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--out', type=str,
                   default=os.path.join(REPO, 'runs', 'overfit_6ct7_torch'))
    args = p.parse_args(argv)

    from abx_tpu_torch.cli import runner
    device = runner.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    result_path = os.path.join(args.out, 'result.json')
    if args.eval_only:
        with open(result_path, encoding='utf-8') as f:
            result = json.load(f)
    else:
        result = {'train': train(args, args.out, args.device),
                  'exact_elbo': args.exact_elbo}
    rows, evals = {}, {}
    for name, bf16 in (('f32', False), ('bf16', True)):
        rt = eval_runtime(args, args.out, args.device, bf16)
        rows[name], seconds = evaluate(args, rt)
        evals[name] = {**summarize(rows[name]), 'seconds': seconds}
        for key, options in eval_configs(args):
            r, seconds = evaluate(args, rt, **options)
            result.setdefault(key, {})[name] = {**summarize(r),
                                                'seconds': seconds}
        del rt
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    evals['bf16_minus_f32'] = [
        {'sample': a['sample'], 'h3_rmsd': b['h3_rmsd'] - a['h3_rmsd'],
         'h3_aar': b['h3_aar'] - a['h3_aar']}
        for a, b in zip(rows['f32'], rows['bf16'])]
    result.update({
        'card': card_line(device),
        # The kernel flags the evaluation ran under (unset: the defaults).
        'kernel_flags': {k: v for k, v in sorted(os.environ.items())
                         if k.startswith('ABX_')},
        'generate_area': args.generate_area,
        'esm': ({'random_weights': True, 'layers': args.esm_layers,
                 'dim': args.esm_dim} if args.esm_random else False),
        'tiny': args.tiny, 'batch': args.batch, 'lr': args.lr,
        'num_t': args.num_t, 'eval': evals,
    })
    with open(result_path, 'w', encoding='utf-8') as f:
        json.dump(result, f, indent=1)
    keys = ['eval'] + [k for k, _ in eval_configs(args)]
    print(json.dumps({k: v for k, v in result.items() if k not in keys}))
    print(json.dumps({k: {d: {m: v for m, v in e.items() if m != 'samples'}
                          for d, e in result[k].items()
                          if d != 'bf16_minus_f32'} for k in keys}))
    return result


if __name__ == '__main__':
    main()
