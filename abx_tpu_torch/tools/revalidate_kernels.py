"""Re-validate the kernel stack's end-to-end quality on trained weights.

Counterpart of `tools/revalidate_kernels.py`: sample the EMA weights of
the port's overfit run (`<run_dir>/params.pt`, written by
`abx_tpu_torch/tools/overfit_6ct7.py`) in bf16 on the kernel route that
the `ABX_*` flags of the environment select, by the overfit tool's own
evaluation (num_t 50, chunks of 4 samples, seed 1 + the chunk's first
sample), and hold each sample's H3 RMSD against its f32 twin: the
per-sample `eval.f32.samples` of `<run_dir>/result.json`, from an
`--eval_only` run of the overfit tool at the same `--num_samples`.  The
bar is the JAX tool's: every per-sample |bf16 - f32| <= 0.05 A and mean
AAR >= 0.99.  Prints `QUALITY OK` or `QUALITY REGRESSED` and exits 1 on a
regression.

Writes `<run_dir>/bf16_kernel_eval_<tag>.json`: the JAX tool's fields,
then every per-sample |delta| with their mean, the counts over 0.05 A and
over 0.1 A, the per-sample AAR, the kernel flags and the card.

    python -m abx_tpu_torch.tools.overfit_6ct7 --eval_only --num_samples 32
    python -m abx_tpu_torch.tools.revalidate_kernels --num_samples 32 \\
        --tag kernels32
    ABX_FUSED_TRI_ATTN=0 ... python -m abx_tpu_torch.tools.revalidate_kernels \\
        --num_samples 32 --tag plain32     # the plain route: every flag 0

`--device` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

from abx_tpu_torch.tools import overfit_6ct7

DELTA_BAR = 0.05   # A: every sample's |bf16 - f32| H3 RMSD
AAR_BAR = 0.99     # mean amino-acid recovery


def judge(f32_rmsd, rows, what):
    """The JAX tool's record and bar for the bf16 `rows` (`evaluate`'s)
    against the f32 RMSDs of the same samples.  Returns (record, ok)."""
    rmsds = [r['h3_rmsd'] for r in rows]
    aars = [r['h3_aar'] for r in rows]
    deltas = [abs(a - b) for a, b in zip(rmsds, f32_rmsd)]
    record = {
        'what': what,
        'f32_h3_rmsd_per_sample': [round(r, 3) for r in f32_rmsd],
        'bf16_h3_rmsd_per_sample': [round(r, 3) for r in rmsds],
        'f32_h3_rmsd_mean': round(float(np.mean(f32_rmsd)), 3),
        'bf16_h3_rmsd_mean': round(float(np.mean(rmsds)), 3),
        'max_per_sample_delta': round(max(deltas), 3),
        'aar_mean': round(float(np.mean(aars)), 3),
        'abs_delta_per_sample': deltas,
        'mean_per_sample_delta': float(np.mean(deltas)),
        'n_over_0.05': sum(d > 0.05 for d in deltas),
        'n_over_0.1': sum(d > 0.1 for d in deltas),
        'aar_per_sample': aars,
    }
    ok = max(deltas) <= DELTA_BAR and float(np.mean(aars)) >= AAR_BAR
    return record, ok


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--run_dir', default=os.path.join(
        overfit_6ct7.REPO, 'runs', 'overfit_6ct7_torch'))
    p.add_argument('--num_t', type=int, default=50)
    p.add_argument('--num_samples', type=int, default=4)
    p.add_argument('--tag', default='kernels',
                   help='suffix of the output file')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    from abx_tpu_torch.cli import runner
    device = runner.resolve_device(args.device)
    with open(os.path.join(args.run_dir, 'result.json'),
              encoding='utf-8') as f:
        prior = json.load(f)
    f32_rows = prior['eval']['f32']['samples']
    if len(f32_rows) != args.num_samples or prior['num_t'] != args.num_t:
        raise SystemExit(
            f'{args.run_dir}/result.json holds {len(f32_rows)} f32 samples '
            f'at num_t {prior["num_t"]}: run the overfit tool with '
            f'--eval_only --num_samples {args.num_samples} --num_t '
            f'{args.num_t} first')
    esm = prior['esm'] or {}
    # The overfit run's settings, as its evaluation takes them.
    ev = types.SimpleNamespace(
        tiny=prior['tiny'], generate_area=prior['generate_area'],
        num_t=args.num_t, num_samples=args.num_samples,
        esm_random=bool(esm), esm_layers=esm.get('layers'),
        esm_dim=esm.get('dim'))
    rt = overfit_6ct7.eval_runtime(ev, args.run_dir, args.device, bf16=True)
    rows, seconds = overfit_6ct7.evaluate(ev, rt)
    f32_rmsd = [r['h3_rmsd'] for r in f32_rows]
    for r, f in zip(rows, f32_rmsd):
        print(f'sample {r["sample"]}: rmsd={r["h3_rmsd"]:.3f} A (f32 '
              f'{f:.3f})  aar={r["h3_aar"]:.3f}')
    card = overfit_6ct7.card_line(device)
    flags = {k: v for k, v in sorted(os.environ.items())
             if k.startswith('ABX_')}
    record, ok = judge(
        f32_rmsd, rows,
        f'bf16 eval of the f32-trained overfit model on the kernel route '
        f'of the ABX_* flags ({args.tag}), same seeds, num_t={args.num_t}, '
        f'B={args.num_samples}, {card}')
    record.update({'quality': 'OK' if ok else 'REGRESSED',
                   'kernel_flags': flags, 'card': card, 'seconds': seconds,
                   'samples': rows})
    out_path = os.path.join(args.run_dir,
                            f'bf16_kernel_eval_{args.tag}.json')
    with open(out_path, 'w', encoding='utf-8') as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ('samples', 'abs_delta_per_sample',
                                   'aar_per_sample')}))
    print('QUALITY', 'OK' if ok else 'REGRESSED')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
