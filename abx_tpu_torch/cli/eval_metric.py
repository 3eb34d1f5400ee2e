"""Batch RMSD/AAR evaluation over an output directory (reference
eval_metric.py): compares every predicted PDB under `--data_dir` against the
matching ground truth in `<data_dir>/reference/`, writes results.csv.

The port's own copy of `abx_tpu/cli/eval_metric.py` (host only; the same
results.csv), on the port's evaluation modules:

    python -m abx_tpu_torch.cli.eval_metric --data_dir out/design

With `--energy` each design's interface energy is compared against its
reference complex and the IMP metric — the percentage of designs whose ΔG
improves on the reference, the headline optimize-mode metric
(reference README.md:150, eval/metric_scripts/analyze_energy.py) — is
aggregated per optimize strength (OPT-<k> subdirectory) into imp.csv.
"""

from __future__ import annotations

import argparse
import csv
import functools
import glob
import logging
import multiprocessing as mp
import os
import re
import time
from typing import Dict, Optional

import numpy as np

from abx_tpu_torch.evaluation.metrics import calc_ab_metrics, make_coords

logger = logging.getLogger(__name__)


def eval_one(pred_file: str, ref: Dict) -> Optional[Dict]:
    name = os.path.splitext(os.path.basename(pred_file))[0]
    parts = name.split('_')
    heavy, light = (parts[1], parts[2]) if len(parts) >= 3 else ('H', 'L')
    pred = make_coords(pred_file, heavy, light)
    if pred is None or len(pred['seq']) != len(ref['seq']):
        logger.warning('skip %s (parse/length mismatch)', pred_file)
        return None
    mask = (pred['mask'] > 0) & (ref['mask'] > 0)
    metrics = calc_ab_metrics(ref['coords'], pred['coords'], mask,
                              ref['cdr_def'], ref['seq'], pred['seq'])
    metrics['name'] = name
    metrics['file'] = pred_file
    return metrics


def eval_with_energy(pred_file: str, ref: Dict,
                     energy: bool = False) -> Optional[Dict]:
    m = eval_one(pred_file, ref)
    if m is not None and energy:
        from abx_tpu_torch.evaluation.relax import interface_energy
        name = os.path.splitext(os.path.basename(pred_file))[0]
        parts = name.split('_')
        ab = parts[1:3] if len(parts) >= 3 else ['H', 'L']
        ag = parts[3].split('|') if len(parts) > 3 else []
        try:
            e, backend = interface_energy(pred_file, ab, ag)
            m['interface_energy'] = e
            m['energy_backend'] = backend
        except Exception as exc:
            logger.warning('energy failed for %s: %s', pred_file, exc)
    return m


def reference_energy(ref_file: str) -> Optional[float]:
    """Interface energy of a ground-truth complex PDB."""
    from abx_tpu_torch.evaluation.relax import interface_energy
    name = os.path.splitext(os.path.basename(ref_file))[0]
    parts = name.split('_')
    ab = parts[1:3] if len(parts) >= 3 else ['H', 'L']
    ag = parts[3].split('|') if len(parts) > 3 else []
    try:
        e, _ = interface_energy(ref_file, ab, ag)
        return e
    except Exception as exc:
        logger.warning('reference energy failed for %s: %s', ref_file, exc)
        return None


def _opt_group(path: str) -> str:
    """Group label from the output layout: OPT-<k> subdir or 'design'."""
    m = re.search(r'(?:^|/)(OPT-\d+)(?:/|$)', path)
    return m.group(1) if m else 'design'


def aggregate_imp(results, ref_energies) -> list:
    """IMP per optimize strength: % designs with ΔG below the reference."""
    groups = {}
    for r in results:
        e = r.get('interface_energy')
        ref_e = ref_energies.get(r['name'].split('@')[0])
        if e is None or ref_e is None:
            continue
        g = groups.setdefault(_opt_group(r['file']), [])
        g.append((e, ref_e))
    rows = []
    for name in sorted(groups):
        pairs = groups[name]
        improved = [e < ref_e for e, ref_e in pairs]
        rows.append({
            'group': name,
            'n': len(pairs),
            'imp_pct': round(100.0 * np.mean(improved), 2),
            'mean_energy': round(float(np.mean([e for e, _ in pairs])), 3),
            'mean_ref_energy': round(
                float(np.mean([re_ for _, re_ in pairs])), 3),
        })
    return rows


def _no_clobber(csv_path: str) -> None:
    """Preserve a pre-existing results file instead of overwriting it
    (losing, e.g., an earlier --energy column was a real footgun)."""
    if os.path.exists(csv_path):
        stamp = time.strftime('%Y%m%d-%H%M%S',
                              time.localtime(os.path.getmtime(csv_path)))
        backup = f'{csv_path}.{stamp}.bak'
        os.replace(csv_path, backup)
        logger.warning('existing %s moved to %s', csv_path, backup)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--output_csv', type=str, default=None)
    p.add_argument('--energy', action='store_true',
                   help='also compute interface energy (PyRosetta ref2015 '
                        'when available, else LJ proxy) and aggregate IMP')
    p.add_argument('--overwrite', action='store_true',
                   help='overwrite an existing results.csv instead of '
                        'backing it up with a timestamp suffix')
    p.add_argument('--cpus', type=int, default=1)
    p.add_argument('--verbose', action='store_true')
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO)

    ref_dir = os.path.join(args.data_dir, 'reference')
    refs = {}
    for f in glob.glob(os.path.join(ref_dir, '*.pdb')):
        name = os.path.splitext(os.path.basename(f))[0]
        parts = name.split('_')
        heavy, light = (parts[1], parts[2]) if len(parts) >= 3 else ('H', 'L')
        ref = make_coords(f, heavy, light)
        if ref is not None:
            refs[name] = ref

    pred_files = sorted(
        set(glob.glob(os.path.join(args.data_dir, '**', '*.pdb'),
                      recursive=True))
        - set(glob.glob(os.path.join(ref_dir, '*.pdb'))))

    jobs = []
    for f in pred_files:
        name = os.path.splitext(os.path.basename(f))[0].split('@')[0]
        if name in refs:
            jobs.append((f, refs[name]))

    worker = functools.partial(eval_with_energy, energy=args.energy)
    if args.cpus > 1:
        # eval_with_energy is module-level so the pool can pickle it
        # (--energy and --cpus compose).
        with mp.get_context('spawn').Pool(args.cpus) as pool:
            results = pool.starmap(worker, jobs)
    else:
        results = [worker(*j) for j in jobs]
    results = [r for r in results if r]

    if not results:
        logger.warning('no results')
        return

    ref_energies = {}
    if args.energy:
        ref_jobs = sorted(glob.glob(os.path.join(ref_dir, '*.pdb')))
        if args.cpus > 1:
            with mp.get_context('spawn').Pool(args.cpus) as pool:
                energies = pool.map(reference_energy, ref_jobs)
        else:
            energies = [reference_energy(f) for f in ref_jobs]
        for f, e in zip(ref_jobs, energies):
            if e is not None:
                ref_energies[
                    os.path.splitext(os.path.basename(f))[0]] = e
        for r in results:
            ref_e = ref_energies.get(r['name'].split('@')[0])
            if ref_e is not None and 'interface_energy' in r:
                r['ref_interface_energy'] = ref_e
                r['energy_improved'] = int(r['interface_energy'] < ref_e)

    csv_path = args.output_csv or os.path.join(args.data_dir, 'results.csv')
    if not args.overwrite:
        _no_clobber(csv_path)
    keys = sorted({k for r in results for k in r})
    with open(csv_path, 'w', newline='', encoding='utf-8') as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(results)

    for metric in ['full_rmsd', 'h3_rmsd', 'h3_aar']:
        vals = [r[metric] for r in results if metric in r]
        if vals:
            print(f'{metric}: mean={np.mean(vals):.3f} n={len(vals)}')
    print(f'wrote {csv_path}')

    if args.energy:
        imp_rows = aggregate_imp(results, ref_energies)
        if imp_rows:
            imp_path = os.path.join(os.path.dirname(csv_path), 'imp.csv')
            if not args.overwrite:
                _no_clobber(imp_path)
            with open(imp_path, 'w', newline='', encoding='utf-8') as f:
                writer = csv.DictWriter(f, fieldnames=list(imp_rows[0]))
                writer.writeheader()
                writer.writerows(imp_rows)
            for row in imp_rows:
                print(f"IMP[{row['group']}]: {row['imp_pct']}% of "
                      f"{row['n']} designs improve on the reference ΔG")
            print(f'wrote {imp_path}')


if __name__ == '__main__':
    main()
