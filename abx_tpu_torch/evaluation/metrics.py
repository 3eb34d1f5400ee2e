"""Structure/sequence quality metrics (numpy, host-side).

The port's own copy of `abx_tpu/evaluation/metrics.py` (numpy only; the
same names and results).  Parity surface: the reference's abx/utils.py
(Kabsch :412, RMSD :517, GDT :525, TM-score :562, lDDT :623, contact
precision :765) and abx/common/ab_utils.py:124-167 (`calc_ab_metrics`: global
Kabsch alignment then per-CDR RMSD + amino-acid recovery, with the CDR-H3
"Loop" trim variants).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from abx_tpu_torch.common import residue_constants as rc


def kabsch(mobile: np.ndarray, target: np.ndarray):
    """Optimal superposition of mobile onto target; both (N, 3).

    Returns (rotation (3,3), translation (3,)) mapping mobile -> target.
    """
    mu_m = mobile.mean(axis=0)
    mu_t = target.mean(axis=0)
    m = mobile - mu_m
    t = target - mu_t
    h = m.T @ t
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    rot = vt.T @ diag @ u.T
    trans = mu_t - rot @ mu_m
    return rot, trans


def apply_kabsch(mobile: np.ndarray, rot: np.ndarray, trans: np.ndarray):
    return mobile @ rot.T + trans


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def aligned_rmsd(mobile: np.ndarray, target: np.ndarray) -> float:
    rot, trans = kabsch(mobile, target)
    return rmsd(apply_kabsch(mobile, rot, trans), target)


def gdt(a: np.ndarray, b: np.ndarray,
        cutoffs: Sequence[float] = (1.0, 2.0, 4.0, 8.0)) -> float:
    dist = np.linalg.norm(a - b, axis=-1)
    return float(np.mean([np.mean(dist <= c) for c in cutoffs]))


def tm_score(a: np.ndarray, b: np.ndarray, L: Optional[int] = None) -> float:
    """TM-score of pre-aligned coordinate sets (abx/utils.py:562)."""
    n = a.shape[0]
    L = L or n
    d0 = 1.24 * np.cbrt(max(L, 19) - 15) - 1.8
    dist = np.linalg.norm(a - b, axis=-1)
    return float(np.mean(1.0 / (1.0 + (dist / d0) ** 2)))


def lddt_ca(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
            cutoff: float = 15.0,
            thresholds: Sequence[float] = (0.5, 1.0, 2.0, 4.0)) -> np.ndarray:
    """Per-residue lDDT on CA coordinates; (L, 3) inputs, (L,) mask."""
    d_pred = np.linalg.norm(pred[:, None] - pred[None, :], axis=-1)
    d_gt = np.linalg.norm(gt[:, None] - gt[None, :], axis=-1)
    pair_mask = (mask[:, None] * mask[None, :] *
                 (d_gt < cutoff) * (1 - np.eye(len(mask))))
    delta = np.abs(d_pred - d_gt)
    score = np.zeros_like(delta)
    for t in thresholds:
        score += (delta < t)
    score /= len(thresholds)
    denom = pair_mask.sum(axis=-1) + 1e-10
    return (score * pair_mask).sum(axis=-1) / denom


def contact_precision(pred_contact: np.ndarray, truth_dist: np.ndarray,
                      mask: np.ndarray, cutoff: float = 8.0,
                      ratios: Sequence[float] = (0.1, 0.25, 0.5, 1.0),
                      ranges: Sequence = ((6, 12), (12, 24), (24, None))):
    """Top-L/k contact precision by sequence-separation range."""
    n = pred_contact.shape[-1]
    sep = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    pair_mask = mask[:, None] * mask[None, :]
    results = []
    for lo, hi in ranges:
        range_mask = (sep >= lo) & (pair_mask > 0)
        if hi is not None:
            range_mask &= sep < hi
        scores = pred_contact[range_mask]
        labels = (truth_dist < cutoff)[range_mask]
        order = np.argsort(-scores)
        for ratio in ratios:
            k = max(1, int(n * ratio))
            top = order[:k]
            precision = float(labels[top].mean()) if top.size else 0.0
            results.append(((lo, hi), ratio, precision))
    return results


def calc_ab_metrics(gt_coord: np.ndarray, pred_coord: np.ndarray,
                    coord_mask: np.ndarray, cdr_def: np.ndarray,
                    gt_seq: str, pred_seq: str) -> Dict[str, float]:
    """Global Kabsch then per-CDR RMSD + AAR (ab_utils.py:124-167).

    Args:
        gt_coord / pred_coord: (L, 3) CA coordinates.
        coord_mask: (L,) bool.
        cdr_def: (L,) region enums.
        gt_seq / pred_seq: length-L strings.
    """
    sel = coord_mask > 0
    gt_aligned = gt_coord[sel]
    rot, trans = kabsch(pred_coord[sel], gt_aligned)
    pred_aligned = apply_kabsch(pred_coord[sel], rot, trans)
    cdr_sel = cdr_def[sel]
    gt_seq_sel = np.array(list(gt_seq))[sel]
    pred_seq_sel = np.array(list(pred_seq))[sel]

    out = {'full_len': int(sel.sum()),
           'full_rmsd': rmsd(pred_aligned, gt_aligned)}
    for name, enum in rc.cdr_str_to_enum.items():
        idx = np.nonzero(cdr_sel == enum)[0]
        if idx.size == 0:
            continue
        prefix = name.lower()
        out[f'{prefix}_rmsd'] = rmsd(pred_aligned[idx], gt_aligned[idx])
        out[f'{prefix}_aar'] = float(
            (gt_seq_sel[idx] == pred_seq_sel[idx]).mean())
        out[f'{prefix}_len'] = int(idx.size)
        if name == 'H3':
            # "Loop" variants trim the stem residues (ab_utils.py H3 Loop).
            for trim, tag in ((2, 'loop2'), (4, 'loop4')):
                if idx.size > 2 * trim:
                    tidx = idx[trim:-trim]
                    out[f'{prefix}_{tag}_rmsd'] = rmsd(
                        pred_aligned[tidx], gt_aligned[tidx])
                    out[f'{prefix}_{tag}_aar'] = float(
                        (gt_seq_sel[tidx] == pred_seq_sel[tidx]).mean())
    return out


def make_coords(pdb_file: str, heavy_chain: str, light_chain: str
                ) -> Optional[Dict]:
    """CA coordinates + concatenated sequence + CDR labels for an antibody
    PDB (reference metric.py:79-100): variable domains only, H then L."""
    from abx_tpu_torch.data.pdb_io import parse_pdb
    from abx_tpu_torch.preprocess.numbering import annotate_domain
    chains = parse_pdb(pdb_file)
    ca = rc.atom_order['CA']
    seqs, coords, masks, cdr_defs = [], [], [], []
    for cid, tag in ((heavy_chain, 'H'), (light_chain, 'L')):
        if cid not in chains:
            return None
        data = chains[cid]
        ann = annotate_domain(data.str_seq, tag)
        if ann is None:
            return None
        sl = slice(ann.start, ann.end)
        seqs.append(data.str_seq[sl])
        coords.append(data.coords[sl, ca])
        masks.append(data.coord_mask[sl, ca])
        cdr_defs.append(ann.cdr_def)
    return {
        'seq': ''.join(seqs),
        'coords': np.concatenate(coords),
        'mask': np.concatenate(masks),
        'cdr_def': np.concatenate(cdr_defs),
    }


def dihedral_angles(p0, p1, p2, p3):
    """Dihedral about p1-p2 (praxeolitic formula); inputs (..., 3)."""
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1n = b1 / (np.linalg.norm(b1, axis=-1, keepdims=True) + 1e-10)
    v = b0 - np.sum(b0 * b1n, axis=-1, keepdims=True) * b1n
    w = b2 - np.sum(b2 * b1n, axis=-1, keepdims=True) * b1n
    x = np.sum(v * w, axis=-1)
    y = np.sum(np.cross(b1n, v) * w, axis=-1)
    return np.arctan2(y, x)


def backbone_dihedrals(atom14: np.ndarray, mask14: np.ndarray):
    """(phi, psi, omega) per residue from atom14 backbone coordinates."""
    n, ca, c = atom14[:, 0], atom14[:, 1], atom14[:, 2]
    L = atom14.shape[0]
    phi = np.full((L,), np.nan)
    psi = np.full((L,), np.nan)
    omega = np.full((L,), np.nan)
    bb_ok = mask14[:, :3].all(axis=-1)
    for i in range(L):
        if i > 0 and bb_ok[i - 1] and bb_ok[i]:
            phi[i] = dihedral_angles(c[i - 1], n[i], ca[i], c[i])
            omega[i] = dihedral_angles(ca[i - 1], c[i - 1], n[i], ca[i])
        if i < L - 1 and bb_ok[i] and mask14[i + 1, 0]:
            psi[i] = dihedral_angles(n[i], ca[i], c[i], atom14[i + 1, 0])
    return phi, psi, omega


def mds_from_distogram(dist: np.ndarray, num_iter: int = 0) -> np.ndarray:
    """Classical multidimensional scaling: distance matrix -> 3D coords.

    Equivalent surface to the reference's distogram->coordinates embedding
    (abx/utils.py:179-292): double-center the squared distances, take the
    top-3 eigenvectors.
    """
    n = dist.shape[0]
    d2 = np.square(dist)
    j = np.eye(n) - np.ones((n, n)) / n
    b = -0.5 * j @ d2 @ j
    vals, vecs = np.linalg.eigh(b)
    idx = np.argsort(vals)[::-1][:3]
    coords = vecs[:, idx] * np.sqrt(np.maximum(vals[idx], 0.0))
    return coords


def batch_rmsd_vs_npz(pred_dir: str, gt_npz_dir: str):
    """Batch RMSD/AAR of predicted PDBs against ground-truth npz complexes
    (reference eval/make_rmsd.py surface, usable for external predictors)."""
    import glob
    import os
    from abx_tpu_torch.data import dataset as ds_mod
    from abx_tpu_torch.data.pdb_io import parse_pdb

    results = []
    for f in sorted(glob.glob(os.path.join(pred_dir, '*.pdb'))):
        name = os.path.splitext(os.path.basename(f))[0].split('@')[0]
        npz = os.path.join(gt_npz_dir, f'{name}.npz')
        if not os.path.exists(npz):
            continue
        raw = ds_mod.load_complex_npz(npz, name)
        ex = ds_mod._npz_to_example(raw)
        parts = name.split('_')
        heavy, light = (parts[1], parts[2]) if len(parts) >= 3 \
            else ('H', 'L')
        chains = parse_pdb(f)
        if heavy not in chains or light not in chains:
            continue
        pred_seq = chains[heavy].str_seq + chains[light].str_seq
        pred_ca = np.concatenate([chains[heavy].coords[:, 1],
                                  chains[light].coords[:, 1]])
        gt_seq = ex['antibody_str_seq']
        gt_ca = ex['antibody_coords'][:, 1]
        gt_mask = ex['antibody_coord_mask'][:, 1]
        if len(pred_seq) != len(gt_seq):
            continue
        m = calc_ab_metrics(gt_ca, pred_ca, gt_mask,
                            ex['antibody_cdr_def'], gt_seq, pred_seq)
        m['name'] = name
        results.append(m)
    return results
