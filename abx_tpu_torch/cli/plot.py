"""Figure generation over the port's CSV artifacts.

The port's own copy of `abx_tpu/cli/plot.py` (matplotlib is imported
inside `main` only).  Parity surface: the reference's ad-hoc plotting
scripts (eval/metric_scripts/plot_csv.py, analyze_metric.py,
eval/traj_plot/traj_energy.py, traj_pll.py) which parse log files and draw
per-CDR metric distributions and energy-vs-diffusion-time curves.  Those
scripts read bespoke *.log formats; here every producer already writes CSV
(eval_metric -> results.csv, evaluation.trajectory -> trajectory.csv,
trainer -> metrics.csv), so one CLI plots any of them:

    python -m abx_tpu_torch.cli.plot --csv out/design/results.csv
    python -m abx_tpu_torch.cli.plot --csv out/trajectory/trajectory.csv
    python -m abx_tpu_torch.cli.plot --csv runs/exp1/metrics.csv

The kind is auto-detected from the columns (--kind overrides).  Outputs
<csv-stem>.<fmt> next to the CSV (or --output).
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

CDR_METRICS = ['h1', 'h2', 'h3', 'l1', 'l2', 'l3']


def read_csv(path: str) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        raise SystemExit(f'no such csv: {path}')
    with open(path, newline='', encoding='utf-8') as f:
        return list(csv.DictReader(f))


def detect_kind(rows: List[Dict[str, str]]) -> str:
    cols = set(rows[0]) if rows else set()
    if 'time' in cols:
        return 'trajectory'
    if 'step' in cols and 'total' in cols:
        return 'training'
    if any(f'{c}_rmsd' in cols for c in CDR_METRICS) or 'pll' in cols:
        return 'metrics'
    raise SystemExit(f'cannot detect plot kind from columns {sorted(cols)}; '
                     'pass --kind')


def _floats(rows, key):
    out = []
    for r in rows:
        v = r.get(key, '')
        try:
            out.append(float(v))
        except (TypeError, ValueError):
            pass
    return out


def remove_outliers(data):
    """IQR-filter (reference plot_csv.py:25-34 semantics)."""
    if len(data) < 4:
        return list(data)
    q1, q3 = np.percentile(data, 25), np.percentile(data, 75)
    lo, hi = q1 - 1.5 * (q3 - q1), q3 + 1.5 * (q3 - q1)
    return [x for x in data if lo <= x <= hi]


def plot_metrics(rows, ax_grid):
    """Per-CDR RMSD + AAR distributions (+ energy/pll when present)."""
    panels = []
    rmsd = {c: remove_outliers(_floats(rows, f'{c}_rmsd'))
            for c in CDR_METRICS}
    rmsd = {k: v for k, v in rmsd.items() if v}
    if rmsd:
        panels.append(('RMSD (Å)', rmsd, 'box'))
    aar = {c: _floats(rows, f'{c}_aar') for c in CDR_METRICS}
    aar = {k: v for k, v in aar.items() if v}
    if aar:
        panels.append(('AAR', aar, 'box'))
    for extra, label in [('interface_energy', 'interface energy'),
                         ('pll', 'masked PLL'), ('full_rmsd', 'Fv RMSD (Å)')]:
        vals = remove_outliers(_floats(rows, extra))
        if vals:
            panels.append((label, {extra: vals}, 'hist'))
    for ax, (title, data, style) in zip(ax_grid, panels):
        if style == 'box':
            ax.boxplot(list(data.values()), tick_labels=list(data))
        else:
            ax.hist(next(iter(data.values())), bins=30, color='steelblue')
        ax.set_title(f'{title} (n={len(rows)})')
    return len(panels)


def plot_trajectory(rows, ax_grid):
    """Energy-vs-diffusion-time curves (reference traj_energy.py)."""
    per_name = defaultdict(list)
    for r in rows:
        try:
            t, e = float(r['time']), float(r['interface_energy'])
        except (KeyError, ValueError):
            continue
        # One curve per SAMPLE: several samples of the same complex share a
        # name, so disambiguate by the sample subdirectory of the file path.
        sample = os.path.basename(os.path.dirname(r.get('file', '')))
        label = r.get('name', '')
        if sample:
            label = f'{label}/{sample}'
        per_name[label].append((t, e))
    ax = ax_grid[0]
    agg = defaultdict(list)
    for name, pts in sorted(per_name.items()):
        pts.sort(key=lambda x: -x[0])
        ts, es = zip(*pts)
        ax.plot(ts, es, alpha=0.35, linewidth=1.0, label=name)
        for t, e in pts:
            agg[t].append(e)
    if agg:
        ts = sorted(agg, reverse=True)
        ax.plot(ts, [float(np.mean(agg[t])) for t in ts], color='black',
                linewidth=2.5, label='mean')
    ax.invert_xaxis()  # diffusion runs t: 1 -> 0
    ax.set_xlabel('diffusion time t')
    ax.set_ylabel('interface energy')
    if len(per_name) <= 8:
        ax.legend(fontsize=7)
    return 1


def _series(rows, key):
    """(step, value) pairs parsed TOGETHER per row: a row whose cell for
    `key` is blank/unparsable is skipped for that series only, so later
    points keep their true x positions (mixed-schema appends leave holes)."""
    pts = []
    for r in rows:
        try:
            pts.append((float(r['step']), float(r[key])))
        except (KeyError, ValueError, TypeError):
            continue
    return pts


def plot_training(rows, ax_grid):
    """Loss curves vs step from the trainer metrics sink."""
    if not _floats(rows, 'step'):
        raise SystemExit("csv has no 'step' column - not a trainer "
                         "metrics.csv (wrong --kind?)")
    keys = [k for k in rows[0]
            if k not in ('step', 'steps_per_sec') and _series(rows, k)]
    main = [k for k in ('total', 'seq/aar', 'grad_norm') if k in keys]
    rest = [k for k in keys if k not in main]
    panels = [('loss curves', rest or main)]
    if rest and main:
        panels.insert(0, ('headline', main))
    for ax, (title, ks) in zip(ax_grid, panels):
        for k in ks:
            pts = _series(rows, k)
            ax.plot([s for s, _ in pts], [v for _, v in pts],
                    label=k, linewidth=1.2)
        ax.set_xlabel('step')
        ax.set_yscale('log')
        ax.legend(fontsize=7)
        ax.set_title(title)
    return len(panels)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--csv', type=str, required=True)
    p.add_argument('--kind', type=str, default=None,
                   choices=['metrics', 'trajectory', 'training'])
    p.add_argument('--output', type=str, default=None)
    p.add_argument('--format', type=str, default='png')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import matplotlib
    matplotlib.use('agg')
    import matplotlib.pyplot as plt

    rows = read_csv(args.csv)
    if not rows:
        raise SystemExit(f'no rows in {args.csv}')
    kind = args.kind or detect_kind(rows)
    out = args.output or (os.path.splitext(args.csv)[0] + f'.{args.format}')

    plot_fn = {'metrics': plot_metrics, 'trajectory': plot_trajectory,
               'training': plot_training}[kind]
    # First pass counts the panels the data needs; second pass renders a
    # figure sized exactly to them (no dead axes).
    probe_fig, probe_axes = plt.subplots(2, 3)
    n = plot_fn(rows, np.ravel(probe_axes))
    plt.close(probe_fig)
    cols = min(3, n)
    nrows = -(-n // 3)
    fig, axes = plt.subplots(nrows, cols, figsize=(5 * cols, 4.5 * nrows),
                             squeeze=False)
    axes = np.ravel(axes)
    plot_fn(rows, axes[:n])
    for ax in axes[n:]:
        ax.axis('off')
    fig.suptitle(f'{kind}: {os.path.basename(args.csv)}')
    fig.tight_layout()
    fig.savefig(out, dpi=200)
    print(f'wrote {out} ({kind}, {len(rows)} rows)')


if __name__ == '__main__':
    main()
