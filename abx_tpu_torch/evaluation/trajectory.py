"""Trajectory evaluation: energy/quality curves over diffusion time.

The port's own copy of `abx_tpu/evaluation/trajectory.py` (host only), on
the port's relax, grafting and metrics modules, writing the same CSV.
Parity surface: the reference's eval/traj_evaluate.py — for each trajectory
dump (`<name>@<t>.pdb`):

  * per-step CDR RMSD/AAR vs the ground-truth complex in
    `<data_dir>/reference/` (calc_ab_metrics, ab_utils.py:124-167);
  * interface energy per diffusion time.  When `--original_dir` provides the
    original FULL antibody PDBs, the designed Fv is grafted onto it
    (framework Kabsch + residue replacement, traj_evaluate.py's
    full-antibody reconstruction) and — when PyRosetta is available — side
    chains around the designed region are repacked before scoring ΔG.

Energy backend: PyRosetta dG_separated when available, else the LJ proxy
(evaluation/relax.py) — the backend is recorded per row.
"""

from __future__ import annotations

import csv
import glob
import logging
import os
import re
import tempfile
from typing import Dict, List, Optional

import numpy as np

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import parse_pdb, write_pdb_atoms
from abx_tpu_torch.evaluation.grafting import graft_fv_chain
from abx_tpu_torch.evaluation.metrics import calc_ab_metrics, make_coords
from abx_tpu_torch.evaluation.relax import interface_energy, try_pyrosetta_pack

logger = logging.getLogger(__name__)

_TRAJ_RE = re.compile(r'^(?P<name>.+)@(?P<time>[0-9.]+)$')


def collect_trajectory_files(data_dir: str) -> Dict[str, List[dict]]:
    """Group `<name>@<t>.pdb` files by complex name."""
    groups: Dict[str, List[dict]] = {}
    for f in glob.glob(os.path.join(data_dir, '**', '*.pdb'),
                       recursive=True):
        stem = os.path.splitext(os.path.basename(f))[0]
        m = _TRAJ_RE.match(stem)
        if not m:
            continue
        groups.setdefault(m.group('name'), []).append(
            {'file': f, 'time': float(m.group('time'))})
    for name in groups:
        groups[name].sort(key=lambda x: -x['time'])
    return groups


def _write_chains_pdb(path: str, chains: List) -> None:
    """Write a list of ChainData as one PDB (atom mask respected)."""
    lines = ['REMARK   abx_tpu grafted complex\n']
    serial = 1
    for ch in chains:
        bfac = np.zeros((len(ch.str_seq),))
        res_mask = ch.coord_mask[:, rc.atom_order['CA']]
        serial = write_pdb_atoms(lines, ch.str_seq, ch.coords, ch.chain_id,
                                 bfac, res_mask=res_mask,
                                 serial_start=serial)
    lines.append('END\n')
    with open(path, 'w', encoding='utf-8') as f:
        f.writelines(lines)


def graft_onto_original(step_file: str, original_file: str,
                        heavy: str, light: str, antigens: List[str],
                        out_file: str, repack: bool = True
                        ) -> Optional[str]:
    """Rebuild the full antibody with the designed Fv; return the PDB path.

    Reference traj_evaluate.py grafts the designed variable domains onto the
    original full antibody, repacks, and scores THAT complex — raw
    trajectory PDBs only contain the Fv + cropped antigen patch.
    """
    designed = parse_pdb(step_file)
    original = parse_pdb(original_file)
    grafted = []
    for cid, tag in ((heavy, 'H'), (light, 'L')):
        if cid not in designed or cid not in original:
            return None
        g = graft_fv_chain(original[cid], designed[cid], tag)
        if g is None:
            return None
        grafted.append(g)
    for cid in antigens:
        if cid not in original:
            return None
        grafted.append(original[cid])
    _write_chains_pdb(out_file, grafted)
    if repack:
        packed = try_pyrosetta_pack(out_file)
        if packed is not None:
            return packed
    return out_file


def evaluate_trajectory(data_dir: str, output_csv: Optional[str] = None,
                        with_energy: bool = True,
                        original_dir: Optional[str] = None,
                        repack: bool = True) -> List[dict]:
    """Per-timestep metrics for every trajectory under data_dir."""
    groups = collect_trajectory_files(data_dir)
    ref_dir = os.path.join(data_dir, 'reference')
    rows = []
    refs: Dict[str, Optional[dict]] = {}
    for name, steps in groups.items():
        parts = name.split('_')
        heavy, light = (parts[1], parts[2]) if len(parts) >= 3 \
            else ('H', 'L')
        antigen = parts[3].split('|') if len(parts) > 3 else []
        # Ground truth for per-step RMSD/AAR curves.
        if name not in refs:
            ref_pdb = os.path.join(ref_dir, f'{name}.pdb')
            refs[name] = (make_coords(ref_pdb, heavy, light)
                          if os.path.exists(ref_pdb) else None)
        ref = refs[name]
        original_file = (os.path.join(original_dir, f'{name}.pdb')
                         if original_dir else None)
        for step in steps:
            row = {'name': name, 'time': step['time'],
                   'file': step['file']}
            if ref is not None:
                pred = make_coords(step['file'], heavy, light)
                if pred is not None and len(pred['seq']) == len(ref['seq']):
                    mask = (pred['mask'] > 0) & (ref['mask'] > 0)
                    row.update(calc_ab_metrics(
                        ref['coords'], pred['coords'], mask,
                        ref['cdr_def'], ref['seq'], pred['seq']))
            if with_energy:
                energy_file = step['file']
                if original_file and os.path.exists(original_file):
                    with tempfile.TemporaryDirectory() as td:
                        g = graft_onto_original(
                            step['file'], original_file, heavy, light,
                            antigen, os.path.join(td, 'grafted.pdb'),
                            repack=repack)
                        row.update(_energy_row(
                            g or energy_file, heavy, light, antigen,
                            grafted=g is not None))
                else:
                    row.update(_energy_row(energy_file, heavy, light,
                                           antigen, grafted=False))
            rows.append(row)
    if output_csv and rows:
        keys = sorted({k for r in rows for k in r})
        with open(output_csv, 'w', newline='', encoding='utf-8') as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        logger.info('wrote %s (%d rows)', output_csv, len(rows))
    return rows


def _energy_row(pdb_file: str, heavy: str, light: str,
                antigen: List[str], grafted: bool) -> dict:
    try:
        e, backend = interface_energy(pdb_file, [heavy, light], antigen)
        return {'interface_energy': e, 'energy_backend': backend,
                'grafted': int(grafted)}
    except Exception as exc:
        logger.warning('%s: energy failed (%s)', pdb_file, exc)
        return {}


def summarize_by_time(rows: List[dict]) -> List[dict]:
    """Mean interface energy / CDR-H3 RMSD / AAR per diffusion time."""
    by_time: Dict[float, Dict[str, List[float]]] = {}
    for r in rows:
        slot = by_time.setdefault(r['time'], {})
        for key in ('interface_energy', 'h3_rmsd', 'h3_aar'):
            if key in r:
                slot.setdefault(key, []).append(r[key])
    out = []
    for t, vals in sorted(by_time.items(), reverse=True):
        row = {'time': t,
               'n': max((len(v) for v in vals.values()), default=0)}
        for key, v in vals.items():
            row[f'mean_{key}'] = float(np.mean(v))
        out.append(row)
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, required=True)
    p.add_argument('--output_csv', type=str, default=None)
    p.add_argument('--no_energy', action='store_true')
    p.add_argument('--original_dir', type=str, default=None,
                   help='directory of original FULL antibody PDBs '
                        '(<name>.pdb); designed Fvs are grafted onto them '
                        'before energy scoring')
    p.add_argument('--no_repack', action='store_true',
                   help='skip the PyRosetta side-chain repack after '
                        'grafting')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = args.output_csv or os.path.join(args.data_dir, 'trajectory.csv')
    rows = evaluate_trajectory(args.data_dir, out,
                               with_energy=not args.no_energy,
                               original_dir=args.original_dir,
                               repack=not args.no_repack)
    for s in summarize_by_time(rows):
        parts = [f"t={s['time']:.3f}"]
        for k in ('mean_interface_energy', 'mean_h3_rmsd', 'mean_h3_aar'):
            if k in s:
                parts.append(f"{k.replace('mean_', '')}={s[k]:.3f}")
        print(' '.join(parts) + f" (n={s['n']})")


if __name__ == '__main__':
    main()
