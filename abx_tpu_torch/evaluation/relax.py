"""Structure relaxation + interface energy.

Counterpart of `abx_tpu/evaluation/relax.py`.  Parity surface: the
reference's abx/relax.py (PyRosetta FastRelax restricted to CDR backbones +
neighbouring side chains, ref2015 score) and abx/common/energy.py
(InterfaceAnalyzerMover dG_separated).

Two backends, as in the JAX package:
  * `pyrosetta` — used when importable: faithful FastRelax + dG_separated
    (`interface_energy`, `try_pyrosetta_pack`; copied as they are);
  * `gradient_relax` (always available) — Adam on an AF2-style violation
    energy (ideal backbone bond lengths, van der Waals clashes, within-
    residue bounds) over the CDR atoms, with harmonic restraints to the
    input coordinates: the counterpart of the JAX package's `jax_relax`,
    with the same `RelaxConfig`, energy and returns.  The JAX package runs
    the steps in one jitted `lax.scan`; here they are a Python loop of
    autograd steps on the caller's device.  The violation energy holds an
    (L, L, 14, 14) clash tensor; the relaxer has no weights and launches
    no hand-written kernel.

The interface energy fallback is a Lennard-Jones 6-12 contact score across
the antibody/antigen interface (numpy) — a *proxy* (labelled in output) for
ranking designs when PyRosetta is unavailable; absolute values are not
comparable to ref2015.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from abx_tpu_torch.common import residue_constants as rc

# Ideal backbone geometry (Engh & Huber values, as used by AF2 violations).
BOND_N_CA = 1.458
BOND_CA_C = 1.525
BOND_C_O = 1.231
BOND_C_N = rc.between_res_bond_length_c_n[0]
BOND_C_N_PRO = rc.between_res_bond_length_c_n[1]


@dataclasses.dataclass(frozen=True)
class RelaxConfig:
    iterations: int = 200
    learning_rate: float = 2e-3
    restraint_weight: float = 1.0
    clash_weight: float = 10.0
    bond_weight: float = 10.0
    clash_overlap_tolerance: float = 1.5


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _pair_dist(a, b):
    return torch.sqrt(torch.sum(torch.square(a - b), -1) + 1e-8)


def violation_energy(atom14, seq, atom_exists, residx,
                     clash_overlap_tolerance: float = 1.5):
    """Differentiable violation energy of an atom14 structure.

    Args: atom14 (L, 14, 3) f32; seq (L,) int; atom_exists (L, 14) f32;
        residx (L,) int; all tensors on one device.
    Returns (total, dict of terms), 0-d f32 tensors; all terms are
    mean-per-violating-pair so the magnitude is interpretable across
    lengths.
    """
    dev = atom14.device
    n_pos, ca_pos, c_pos, o_pos = (atom14[:, i] for i in range(4))
    mask_n, mask_ca, mask_c, mask_o = (atom_exists[:, i] for i in range(4))

    def bond_term(a, b, ideal, m):
        d = _pair_dist(a, b)
        return torch.sum(torch.square(d - ideal) * m) / (torch.sum(m) + 1e-6)

    bonds = (bond_term(n_pos, ca_pos, BOND_N_CA, mask_n * mask_ca)
             + bond_term(ca_pos, c_pos, BOND_CA_C, mask_ca * mask_c)
             + bond_term(c_pos, o_pos, BOND_C_O, mask_c * mask_o))

    # Peptide bond C(i)-N(i+1) within chains.
    consecutive = (residx[1:] - residx[:-1] == 1).float()
    is_pro = (seq[1:] == rc.restype_order['P']).float()
    ideal_cn = BOND_C_N * (1 - is_pro) + BOND_C_N_PRO * is_pro
    m_pep = mask_c[:-1] * mask_n[1:] * consecutive
    d_cn = _pair_dist(c_pos[:-1], n_pos[1:])
    bonds = bonds + torch.sum(torch.square(d_cn - ideal_cn) * m_pep) / (
        torch.sum(m_pep) + 1e-6)

    # Clashes between non-bonded atom pairs.
    seq_c = torch.clamp(seq.long(), 0, rc.restype_num)
    radii = _f32(rc.atom14_element_radii(), dev)[seq_c]
    l = seq.shape[0]
    d = _pair_dist(atom14[:, None, :, None, :], atom14[None, :, None, :, :])
    pair_exist = atom_exists[:, None, :, None] * atom_exists[None, :, None, :]
    eye = torch.eye(l, device=dev)
    same = eye[:, :, None, None]
    ones = torch.ones(l - 1, device=dev)
    neighbor = (torch.diag(ones, 1) + torch.diag(ones, -1))[:, :, None, None]
    allowed = (radii[:, None, :, None] + radii[None, :, None, :]
               - clash_overlap_tolerance)
    clash = torch.square(torch.clamp(allowed - d, min=0.0))
    clash_mask = pair_exist * (1 - same) * (1 - neighbor)
    clash_e = torch.sum(clash * clash_mask) / (torch.sum(clash_mask) + 1e-6)

    # Within-residue stereo bounds (Engh & Huber; the reference's
    # residue_constants.py:483-525): covalent/virtual bond pairs within
    # each residue must stay in [lower, upper].
    bounds = rc.make_atom14_dists_bounds(
        overlap_tolerance=clash_overlap_tolerance)
    lo = _f32(bounds['lower_bound'], dev)[seq_c]   # (L, 14, 14)
    hi = _f32(bounds['upper_bound'], dev)[seq_c]
    dw = _pair_dist(atom14[:, :, None, :], atom14[:, None, :, :])
    w_mask = (atom_exists[:, :, None] * atom_exists[:, None, :]
              * (1.0 - torch.eye(14, device=dev)) * (hi > 0).float())
    w_err = (torch.clamp(lo - dw, min=0.0)
             + torch.clamp(dw - torch.where(hi > 0, hi,
                                            torch.full_like(hi, 1e10)),
                           min=0.0))
    within_e = torch.sum(torch.square(w_err) * w_mask) / (
        torch.sum(w_mask) + 1e-6)

    total = bonds + clash_e + within_e
    return total, {'bond': bonds, 'clash': clash_e, 'within': within_e}


def gradient_relax(atom14, seq, atom_exists, residx, move_mask,
                   config: RelaxConfig = RelaxConfig(), device='cuda'):
    """Minimise violation energy over `move_mask` atoms (1 = movable).

    Counterpart of the JAX package's `jax_relax`: `config.iterations` steps
    of Adam (`torch.optim.Adam`: b1 0.9, b2 0.999, eps 1e-8, bias-corrected,
    the update of `optax.adam`) on bond + clash energy plus the restraint.
    Atoms of immobile residues come back bitwise equal to the input.

    Args:
        atom14: (L, 14, 3); seq (L,); atom_exists (L, 14); residx (L,);
        move_mask: (L,) residues allowed to move (numpy arrays or tensors).
        device: where the steps run ('cuda' by default; 'cpu' when asked).
    Returns (relaxed atom14 as numpy f32, metrics before/after).
    """
    dev = torch.device(device)
    init = _f32(atom14, dev)
    seq = torch.as_tensor(np.asarray(seq), device=dev).long()
    exists = _f32(atom_exists, dev)
    residx = torch.as_tensor(np.asarray(residx), device=dev).long()
    move = _f32(move_mask, dev)[:, None, None]
    moved = move * exists[..., None]

    def energy(x):
        pos = init * (1 - move) + x * move
        _, terms = violation_energy(pos, seq, exists, residx,
                                    config.clash_overlap_tolerance)
        restraint = torch.sum(torch.square(x - init) * moved) / (
            torch.sum(moved) + 1e-6)
        return (config.bond_weight * terms['bond']
                + config.clash_weight * terms['clash']
                + config.restraint_weight * restraint), terms

    x = init.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=config.learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    with torch.no_grad():
        e0, terms0 = energy(x)
    for _ in range(config.iterations):
        opt.zero_grad()
        e, _ = energy(x)
        e.backward()
        opt.step()
    with torch.no_grad():
        e1, terms1 = energy(x)
        relaxed = init * (1 - move) + x * move
    metrics = {
        'energy_before': float(e0), 'energy_after': float(e1),
        'bond_before': float(terms0['bond']),
        'bond_after': float(terms1['bond']),
        'clash_before': float(terms0['clash']),
        'clash_after': float(terms1['clash']),
    }
    return relaxed.cpu().numpy(), metrics


# -- interface energy -------------------------------------------------------

def lj_interface_score(atom14_ab, exists_ab, seq_ab,
                       atom14_ag, exists_ag, seq_ag) -> float:
    """Lennard-Jones 6-12 cross-interface score (proxy for dG_separated).

    More negative = more favourable packed interface.
    """
    r_ab = rc.atom14_element_radii()[np.clip(seq_ab, 0, rc.restype_num)]
    r_ag = rc.atom14_element_radii()[np.clip(seq_ag, 0, rc.restype_num)]
    a = np.asarray(atom14_ab).reshape(-1, 3)
    b = np.asarray(atom14_ag).reshape(-1, 3)
    ma = np.asarray(exists_ab).reshape(-1) > 0
    mb = np.asarray(exists_ag).reshape(-1) > 0
    ra = r_ab.reshape(-1)[ma]
    rb = r_ag.reshape(-1)[mb]
    a, b = a[ma], b[mb]
    d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    sigma = (ra[:, None] + rb[None, :]) * 0.95
    near = d < 10.0
    with np.errstate(over='ignore'):
        x6 = (sigma / np.maximum(d, 0.5)) ** 6
        lj = x6 * x6 - 2 * x6
    return float(np.sum(lj[near]))


def interface_energy(pdb_file: str, antibody_chains, antigen_chains
                     ) -> Tuple[float, str]:
    """dG of the antibody-antigen interface.

    PyRosetta ref2015 dG_separated when available (reference energy.py),
    else the LJ proxy (backend tag returned alongside the value).
    """
    try:
        return _pyrosetta_dg(pdb_file, antibody_chains, antigen_chains), \
            'pyrosetta_ref2015'
    except ImportError:
        pass
    from abx_tpu_torch.data.pdb_io import parse_pdb
    chains = parse_pdb(pdb_file)
    ab = [chains[c] for c in antibody_chains if c in chains]
    ag = [chains[c] for c in antigen_chains if c in chains]
    if not ab or not ag:
        return 0.0, 'missing_chains'
    cat = lambda parts, attr: np.concatenate(
        [getattr(p, attr) for p in parts])
    seq = lambda parts: rc.sequence_to_index(
        ''.join(p.str_seq for p in parts))
    score = lj_interface_score(
        cat(ab, 'coords'), cat(ab, 'coord_mask'), seq(ab),
        cat(ag, 'coords'), cat(ag, 'coord_mask'), seq(ag))
    return score, 'lj_proxy'


def try_pyrosetta_pack(pdb_file: str, out_file: str = None
                       ) -> Optional[str]:
    """Side-chain repack of a (grafted) complex; None when PyRosetta absent.

    Reference traj_evaluate.py Rosetta-packs the grafted full antibody
    before interface scoring; grafting changes CDR residue identities, so
    original rotamers are stale there.
    """
    try:
        from pyrosetta import init, pose_from_pdb
        from pyrosetta.rosetta.core.pack.task import TaskFactory
        from pyrosetta.rosetta.protocols.minimization_packing import (
            PackRotamersMover)
    except ImportError:
        return None
    init('-mute all')
    pose = pose_from_pdb(pdb_file)
    tf = TaskFactory()
    task = tf.create_packer_task(pose)
    task.restrict_to_repacking()
    PackRotamersMover(None, task).apply(pose)
    out_file = out_file or pdb_file
    pose.dump_pdb(out_file)
    return out_file


def _pyrosetta_dg(pdb_file, antibody_chains, antigen_chains):
    import pyrosetta  # noqa: F401  raises ImportError when absent
    from pyrosetta import init, pose_from_pdb
    from pyrosetta.rosetta.protocols.analysis import InterfaceAnalyzerMover
    init('-mute all')
    pose = pose_from_pdb(pdb_file)
    interface = (''.join(antibody_chains) + '_'
                 + ''.join(antigen_chains))
    mover = InterfaceAnalyzerMover(interface)
    mover.set_pack_separated(True)
    mover.apply(pose)
    return float(mover.get_interface_dG())
