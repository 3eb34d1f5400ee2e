"""Training losses: score matching on the rigids, the CTMC sequence loss,
backbone and interface FAPE, structural violations, distogram and pLDDT.

Counterpart of abx_tpu/train/losses.py, function for function and with the
same metric names.  The reference ships no loss implementation, only the
configuration (config_model.json's `loss` block); the JAX package rebuilt
the functions from it and the FrameDiff / AF2 conventions, and these are
those functions written on tensors.  Each is a plain function of
(batch, model outputs) -> dict of scalars, masked means, differentiable
with autograd.

Data-parallel training (train/trainer.py) keeps the global-batch loss: each
function takes an optional process `group`, and every reduction over the
batch -- a masked mean over all sites, a ratio of sums, a mean over the
examples -- sums its numerator and its denominator over the group's ranks
(`_sum_over_ranks`) before dividing, so every rank computes the loss of the
whole batch.  The sum passes its gradient through unchanged: a rank's
backward gives its rows' share of the gradient, and the sum of the ranks'
gradients is the whole batch's.  The TM-score and contact metrics stay
this rank's own.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.geometry.quat import safe_norm
from abx_tpu_torch.geometry.rigid import Rigid


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_over_ranks(x, group):
    """`x` summed over the ranks of `group` (None: x itself)."""
    return x if group is None else _SumOverRanks.apply(x, group)


def _ratio(num, den, eps, group):
    """num / (den + eps), num and den summed over the ranks first."""
    return _sum_over_ranks(num, group) / (_sum_over_ranks(den, group) + eps)


def _batch_mean(x, group=None):
    """Mean over the examples (every rank's)."""
    if group is None:
        return torch.mean(x)
    count = torch.tensor(float(x.numel()), device=x.device)
    return _ratio(torch.sum(x), count, 0.0, group)


def masked_mean(mask, value, dim=None, eps: float = 1e-10, group=None):
    if dim is None:
        return _ratio(torch.sum(mask * value), torch.sum(mask), eps, group)
    return torch.sum(mask * value, dim=dim) / (torch.sum(mask, dim=dim) + eps)


def _mse(err2, mask, dim=None):
    return masked_mean(mask, err2, dim)


def _take_last(x, idx):
    """x[..., idx[...]] along the last axis (take_along_axis)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def diffusion_rigids_loss(batch: Dict, folding: Dict, cfg: Any,
                          group=None) -> Dict:
    """Score-matching loss on translations and rotations (FrameDiff):
    translation-score MSE, or the x0 translation loss at t <
    trans_x0_t_threshold; rotation-score axis + angle terms (the angle only
    at t < rot_loss_t_threshold) with `separate_rot_loss`."""
    diffuse_mask = (1 - batch['fixed_mask']) * batch['mask']
    t = batch['t']
    trans_scale = batch['trans_score_scaling'][:, None, None]
    rot_scale = batch['rot_score_scaling'][:, None, None]
    gt_trans_score = batch['trans_score']
    gt_rot_score = batch['rot_score']
    pred_trans_score = folding['trans_score']
    pred_rot_score = folding['rot_score']

    trans_err2 = torch.sum(torch.square(
        (gt_trans_score - pred_trans_score) / trans_scale), dim=-1)
    trans_loss = _mse(trans_err2, diffuse_mask, dim=-1)

    coord_scale = cfg.coordinate_scaling
    gt_trans_0 = batch['rigids_0'][..., 4:] * coord_scale
    pred_trans_0 = folding['rigids'][..., 4:] * coord_scale
    x0_err2 = torch.sum(torch.square(gt_trans_0 - pred_trans_0), dim=-1)
    x0_loss = _mse(x0_err2, diffuse_mask, dim=-1)
    use_x0 = (t < cfg.trans_x0_t_threshold).float()
    trans_total = (use_x0 * x0_loss + (1 - use_x0) * trans_loss) \
        * cfg.trans_loss_weight

    if cfg.separate_rot_loss:
        gt_angle = safe_norm(gt_rot_score)
        pred_angle = safe_norm(pred_rot_score)
        gt_axis = gt_rot_score / (gt_angle + 1e-6)
        pred_axis = pred_rot_score / (pred_angle + 1e-6)
        axis_err2 = torch.sum(torch.square(gt_axis - pred_axis), dim=-1)
        axis_loss = _mse(axis_err2, diffuse_mask, dim=-1)
        angle_err2 = torch.square((gt_angle - pred_angle) / rot_scale)[..., 0]
        angle_loss = _mse(angle_err2, diffuse_mask, dim=-1)
        angle_loss = angle_loss * (t < cfg.rot_loss_t_threshold).float()
        rot_loss = (axis_loss + angle_loss) * cfg.rot_loss_weight
    else:
        rot_err2 = torch.sum(torch.square(
            (gt_rot_score - pred_rot_score) / rot_scale), dim=-1)
        rot_loss = _mse(rot_err2, diffuse_mask, dim=-1) * cfg.rot_loss_weight

    return {'loss': _batch_mean(trans_total + rot_loss, group),
            'trans_loss': _batch_mean(trans_total, group),
            'rot_loss': _batch_mean(rot_loss, group)}


def diffusion_seq_loss(batch: Dict, seq_head: Dict, cfg: Any,
                       group=None) -> Dict:
    """CTMC sequence loss: the posterior-weighted CE surrogate plus
    `nll_weight` x CE, or with `exact_elbo` the tau-leaping ELBO
    (`ctmc_elbo_terms`) plus `nll_weight` x CE."""
    diffuse_mask = (1 - batch['fixed_mask']) * batch['mask']
    logits = seq_head['logits']
    s = logits.shape[-1]
    seq_0 = torch.clamp(batch['seq'].long(), 0, s - 1)
    log_p = F.log_softmax(logits.float(), dim=-1)
    nll = -_take_last(log_p, seq_0)
    aar = masked_mean(diffuse_mask,
                      (torch.argmax(logits, -1) == seq_0).float(),
                      group=group)

    if (cfg.get('exact_elbo', False) and 'rate_t' in batch
            and 'seq_xt' in batch):
        elbo = ctmc_elbo_terms(batch, log_p, cfg.ratio_eps, group)
        loss = elbo['elbo'] + cfg.nll_weight * masked_mean(
            diffuse_mask, nll, group=group)
        return {'loss': loss, 'aar': aar, 'elbo': elbo['elbo'],
                'elbo_norm': elbo['normalizer'], 'elbo_jump': elbo['jump']}

    # q_t0[b, seq_0, seq_t]: the probability that the noising kept x_0.
    q_t0 = batch['q_t0']
    seq_t = torch.clamp(batch['seq_t'].long(), 0, s - 1)
    bi = torch.arange(q_t0.shape[0], device=q_t0.device)[:, None]
    keep_prob = q_t0[bi, seq_0, seq_t]
    elbo_weight = (1.0 - keep_prob + cfg.ratio_eps).detach()
    loss = masked_mean(diffuse_mask, elbo_weight * nll + cfg.nll_weight * nll,
                       group=group)
    return {'loss': loss, 'aar': aar}


def ctmc_elbo_terms(batch: Dict, log_p, eps: float, group=None) -> Dict:
    """Exact tau-leaping CTMC negative-ELBO terms (Campbell et al. 2022):
    the normaliser sum_y Rhat(x_tilde -> y) per diffused site, and the jump
    term Z(x_t) log Rhat(x_tilde -> x_t) at the one corrupted site (zero
    where the diffuse mask reverted the corruption), both over the number
    of diffused sites.  See abx_tpu/train/losses.py for the derivation."""
    diffuse_mask = ((1 - batch['fixed_mask']) * batch['mask']).float()
    b, d_sites, s = log_p.shape
    x_tilde = torch.clamp(batch['seq_t'].long(), 0, s - 1)
    x_t = torch.clamp(batch['seq_xt'].long(), 0, s - 1)
    qt0 = batch['q_t0']          # (B, S, S): q_{t|0}[x0, x_t]
    rate = batch['rate_t']       # (B, S, S)
    p0t = torch.exp(log_p)       # (B, D, S): p(x0 | x_tilde)

    idx = x_tilde[:, None, :].expand(b, s, d_sites)
    qt0_denom = torch.gather(qt0, 2, idx).transpose(1, 2) + eps
    forward_rates = torch.gather(rate, 2, idx).transpose(1, 2)
    inner = torch.einsum('bds,bsy->bdy', p0t / qt0_denom, qt0)
    rhat = forward_rates * inner * (1.0 - F.one_hot(x_tilde, s).float())
    normalizer = masked_mean(diffuse_mask, torch.sum(rhat, dim=-1),
                             group=group)

    differs = (x_tilde != x_t).float() * diffuse_mask
    has_jump = torch.max(differs, dim=-1).values
    sigma = torch.argmax(differs, dim=-1)
    bi = torch.arange(b, device=log_p.device)
    m = x_t[bi, sigma]
    n_til = x_tilde[bi, sigma]
    p_sigma = p0t[bi, sigma]
    ratio = qt0[bi, :, m] / (qt0[bi, :, n_til] + eps)
    rev_jump = rate[bi, m, n_til] * torch.sum(p_sigma * ratio, dim=-1)
    # A reverted corruption has m == n_til and rate[m, m] < 0: 1 stands in
    # inside the log, so the reported loss stays finite.
    log_rev = torch.log(torch.where(has_jump > 0, rev_jump,
                                    torch.ones_like(rev_jump)) + eps)
    rate_out = torch.gather(rate, 1, x_t[:, :, None].expand(b, d_sites, s))
    rate_out = rate_out * (1.0 - F.one_hot(x_t, s).float())
    z_total = torch.sum(torch.sum(rate_out, -1) * diffuse_mask, dim=-1)
    n_sites = torch.sum(diffuse_mask, dim=-1) + 1e-6
    jump = _batch_mean(has_jump * z_total * log_rev / n_sites, group)
    return {'elbo': normalizer - jump, 'normalizer': normalizer,
            'jump': jump}


def backbone_fape(pred_frames: Rigid, gt_frames: Rigid, frames_mask,
                  pred_pos, gt_pos, pos_mask, clamp_distance: float,
                  length_scale: float, unclamped_ratio: float = 0.0,
                  pair_weight=None, eps: float = 1e-6):
    """Frame-aligned point error (AF2 eq. 28) per batch element: frames
    (B, F), positions (B, P, 3), `pair_weight` (B, F, P); returns (B,)."""
    local_pred = pred_frames.invert()[..., None].apply(
        pred_pos[..., None, :, :])
    local_gt = gt_frames.invert()[..., None].apply(gt_pos[..., None, :, :])
    err = torch.sqrt(torch.sum(torch.square(local_pred - local_gt), -1) + eps)
    clamped = torch.clamp(err, 0.0, clamp_distance)
    if unclamped_ratio > 0:
        clamped = (1 - unclamped_ratio) * clamped + unclamped_ratio * err
    mask = frames_mask[..., :, None] * pos_mask[..., None, :]
    if pair_weight is not None:
        mask = mask * pair_weight
    return torch.sum(clamped * mask, dim=(-1, -2)) / (
        length_scale * (torch.sum(mask, dim=(-1, -2)) + 1e-10))


def folding_loss(batch: Dict, folding: Dict, cfg: Any,
                 antibody_len: int, group=None) -> Dict:
    """Backbone FAPE over the IPA trajectory, interface FAPE on the last
    frames, and structural violations; each example gated by its own
    t < t_filter."""
    t = batch['t']
    gate = (t < cfg.t_filter).float()
    gt_bb = batch['rigidgroups_gt_frames'][..., 0]
    gt_mask = (batch['rigidgroups_gt_exists'][..., 0]
               * batch['struc_loss_mask'])
    gt_ca = batch['atom14_gt_positions'][..., 1, :]
    ca_mask = batch['atom14_gt_exists'][..., 1] * batch['struc_loss_mask']

    fape_cfg = cfg.fape
    traj = folding['traj']
    total_bb = 0.0
    for frames in traj:
        total_bb = total_bb + backbone_fape(
            frames, gt_bb, gt_mask, frames.trans, gt_ca, ca_mask,
            clamp_distance=fape_cfg.clamp_distance,
            length_scale=fape_cfg.loss_unit_distance,
            unclamped_ratio=fape_cfg.unclamped_ratio)
    bb_loss = cfg.backbone_fape_weight * total_bb / len(traj)

    icfg = cfg.interface_fape
    b, l = gt_mask.shape
    is_ab = (torch.arange(l, device=gt_mask.device) < antibody_len).float()
    cross = (is_ab[:, None] * (1 - is_ab)[None, :]
             + (1 - is_ab)[:, None] * is_ab[None, :])
    last = traj[-1]
    iface_loss = icfg.interface_weight * backbone_fape(
        last, gt_bb, gt_mask, last.trans, gt_ca, ca_mask,
        clamp_distance=icfg.clamp_distance,
        length_scale=icfg.loss_unit_distance,
        pair_weight=cross.expand(b, l, l))

    viol = violation_loss(batch, folding, cfg, group)
    loss = (_batch_mean(gate * (bb_loss + iface_loss), group)
            + _batch_mean(gate, group) * cfg.structural_violation_loss_weight
            * viol['loss'])
    return {'loss': loss, 'bb_fape': _batch_mean(bb_loss, group),
            'interface_fape': _batch_mean(iface_loss, group),
            'violation': viol['loss']}


def violation_loss(batch: Dict, folding: Dict, cfg: Any,
                   group=None) -> Dict:
    """AF2-style structural violations: the C(i)-N(i+1) bond length and
    the CA-C-N / C-N-CA angles within chains, between-residue clashes over
    all atom14 pairs, and within-residue distance bounds."""
    pos = folding['final_atom14_positions']
    seq = torch.clamp(batch['seq'].long(), 0, rc.restype_num)
    atom_exists = batch['atom14_atom_exists']
    mask = batch['mask']
    dev = pos.device

    c_pos = pos[:, :-1, 2]
    n_pos = pos[:, 1:, 0]
    ca_pos = pos[:, :-1, 1]
    next_ca = pos[:, 1:, 1]
    bond_mask = (atom_exists[:, :-1, 2] * atom_exists[:, 1:, 0]
                 * mask[:, :-1] * mask[:, 1:])
    consecutive = (batch['residx'][:, 1:] - batch['residx'][:, :-1]
                   == 1).float()
    bond_mask = bond_mask * consecutive

    next_is_pro = (seq[:, 1:] == rc.restype_order['P']).float()
    gt_len = (rc.between_res_bond_length_c_n[0] * (1 - next_is_pro)
              + rc.between_res_bond_length_c_n[1] * next_is_pro)
    gt_std = (rc.between_res_bond_length_stddev_c_n[0] * (1 - next_is_pro)
              + rc.between_res_bond_length_stddev_c_n[1] * next_is_pro)
    c_n_len = torch.sqrt(torch.sum(torch.square(c_pos - n_pos), -1) + 1e-6)
    tol = cfg.violation_tolerance_factor
    bond_err = torch.clamp(torch.abs(c_n_len - gt_len) - tol * gt_std,
                           min=0.0)
    bond_loss = _ratio(torch.sum(bond_err * bond_mask), torch.sum(bond_mask),
                       1e-6, group)

    def cos_angle(a, b, c):
        v1 = a - b
        v2 = c - b
        v1 = v1 / torch.sqrt(torch.sum(torch.square(v1), -1, keepdim=True)
                             + 1e-6)
        v2 = v2 / torch.sqrt(torch.sum(torch.square(v2), -1, keepdim=True)
                             + 1e-6)
        return torch.sum(v1 * v2, -1)

    ca_c_n = cos_angle(ca_pos, c_pos, n_pos)
    c_n_ca = cos_angle(c_pos, n_pos, next_ca)
    ang1_err = torch.clamp(
        torch.abs(ca_c_n - rc.between_res_cos_angles_ca_c_n[0])
        - tol * rc.between_res_cos_angles_ca_c_n[1], min=0.0)
    ang2_err = torch.clamp(
        torch.abs(c_n_ca - rc.between_res_cos_angles_c_n_ca[0])
        - tol * rc.between_res_cos_angles_c_n_ca[1], min=0.0)
    angle_loss = _ratio(torch.sum((ang1_err + ang2_err) * bond_mask),
                        torch.sum(bond_mask), 1e-6, group)

    radii = torch.as_tensor(rc.atom14_element_radii(), device=dev)[seq]
    b, l = seq.shape
    d = torch.sqrt(torch.sum(torch.square(
        pos[:, :, None, :, None, :] - pos[:, None, :, None, :, :]), -1)
        + 1e-10)
    pair_exist = (atom_exists[:, :, None, :, None]
                  * atom_exists[:, None, :, None, :])
    res_pair = (mask[:, :, None] * mask[:, None, :])[..., None, None]
    eye = torch.eye(l, device=dev)
    same_res = eye[None, :, :, None, None]
    neighbor = (torch.diag(torch.ones(l - 1, device=dev), 1)
                + torch.diag(torch.ones(l - 1, device=dev), -1)
                )[None, :, :, None, None]
    allowed = (radii[:, :, None, :, None] + radii[:, None, :, None, :]
               - cfg.clash_overlap_tolerance)
    clash = torch.clamp(allowed - d, min=0.0)
    clash_mask = pair_exist * res_pair * (1 - same_res) * (1 - neighbor)
    if cfg.get('average_clashes', True):
        clash_loss = _ratio(torch.sum(clash * clash_mask),
                            torch.sum(clash_mask), 1e-6, group)
    else:
        clash_loss = _ratio(torch.sum(clash * clash_mask),
                            torch.tensor(float(b * l), device=dev), 0.0,
                            group)

    bounds = rc.make_atom14_dists_bounds(
        overlap_tolerance=cfg.clash_overlap_tolerance,
        bond_length_tolerance_factor=tol)
    lo = torch.as_tensor(bounds['lower_bound'], device=dev)[seq]
    hi = torch.as_tensor(bounds['upper_bound'], device=dev)[seq]
    dw = torch.sqrt(torch.sum(torch.square(
        pos[:, :, :, None, :] - pos[:, :, None, :, :]), -1) + 1e-10)
    within_mask = (atom_exists[..., :, None] * atom_exists[..., None, :]
                   * (1.0 - torch.eye(14, device=dev))
                   * mask[..., None, None] * (hi > 0))
    within_err = (torch.clamp(lo - dw, min=0.0)
                  + torch.clamp(dw - torch.where(hi > 0, hi,
                                                 torch.full_like(hi, 1e10)),
                                min=0.0))
    within_loss = _ratio(torch.sum(within_err * within_mask),
                         torch.sum(within_mask), 1e-6, group)

    loss = bond_loss + angle_loss + clash_loss + within_loss
    return {'loss': loss, 'bond': bond_loss, 'angle': angle_loss,
            'clash': clash_loss, 'within': within_loss}


def distogram_loss(batch: Dict, disto: Dict, cfg: Any, group=None) -> Dict:
    """Binned pseudo-beta distance cross entropy, t-gated."""
    logits = disto['logits'].float()
    breaks = disto['breaks']
    pb = batch['pseudo_beta']
    pb_mask = batch['pseudo_beta_mask'] * batch['mask']
    dist2 = torch.sum(torch.square(pb[:, :, None] - pb[:, None, :]), -1)
    true_bins = torch.sum((dist2[..., None] > torch.square(breaks)).long(),
                          -1)
    ce = -_take_last(F.log_softmax(logits, dim=-1), true_bins)
    pair_mask = pb_mask[:, :, None] * pb_mask[:, None, :]
    gate = (batch['t'] < cfg.t_filter).float()
    loss = _batch_mean(gate * torch.sum(ce * pair_mask, (-1, -2))
                       / (torch.sum(pair_mask, (-1, -2)) + 1e-10), group)
    return {'loss': loss}


def predicted_lddt_loss(batch: Dict, plddt_head: Dict, folding: Dict,
                        cfg: Any, group=None) -> Dict:
    """Cross entropy between the predicted lDDT bins and the true
    per-residue CA lDDT (inclusion radius 15 A), t-gated."""
    logits = plddt_head['logits'].float()
    num_bins = logits.shape[-1]
    pred_ca = folding['final_atom14_positions'][..., 1, :]
    gt_ca = batch['atom14_gt_positions'][..., 1, :]
    ca_mask = batch['atom14_gt_exists'][..., 1] * batch['mask']
    d_pred = torch.sqrt(torch.sum(torch.square(
        pred_ca[:, :, None] - pred_ca[:, None, :]), -1) + 1e-10)
    d_gt = torch.sqrt(torch.sum(torch.square(
        gt_ca[:, :, None] - gt_ca[:, None, :]), -1) + 1e-10)
    l = ca_mask.shape[1]
    pair_mask = (ca_mask[:, :, None] * ca_mask[:, None, :] * (d_gt < 15.0)
                 * (1 - torch.eye(l, device=ca_mask.device)[None]))
    delta = torch.abs(d_pred - d_gt)
    score = sum((delta < th).float() for th in (0.5, 1.0, 2.0, 4.0)) / 4.0
    true_lddt = torch.sum(score * pair_mask, -1) / (
        torch.sum(pair_mask, -1) + 1e-10)
    bins = torch.clamp((true_lddt * num_bins).long(), 0, num_bins - 1)
    ce = -_take_last(F.log_softmax(logits, dim=-1), bins)
    gate = (batch['t'] < cfg.t_filter).float()
    return {'loss': _batch_mean(gate * masked_mean(ca_mask, ce, dim=-1),
                                group)}


def total_loss(batch: Dict, outputs: Dict, loss_config: Any,
               antibody_len: int, group=None) -> Dict:
    """Weighted sum of the enabled losses, and the metrics (each loss's
    terms under its prefix, the TM-score and the contact precisions)."""
    heads = outputs['heads']
    metrics = {}
    total = 0.0

    def add(name, prefix, out):
        nonlocal total
        total = total + loss_config[name].weight * out['loss']
        metrics.update({f'{prefix}/{k}': v for k, v in out.items()})

    if loss_config.diffusion_rigids.enabled:
        add('diffusion_rigids', 'rigids', diffusion_rigids_loss(
            batch, heads['folding'], loss_config.diffusion_rigids.config, group))
    if loss_config.diffusion_seq.enabled:
        add('diffusion_seq', 'seq', diffusion_seq_loss(
            batch, heads['sequence_module'],
            loss_config.diffusion_seq.config, group))
    if loss_config.folding.enabled:
        add('folding', 'folding', folding_loss(
            batch, heads['folding'], loss_config.folding.config,
            antibody_len, group))
    if loss_config.distogram.enabled and 'distogram' in heads:
        add('distogram', 'distogram', distogram_loss(
            batch, heads['distogram'], loss_config.distogram.config,
            group))
    if loss_config.predicted_lddt.enabled:
        add('predicted_lddt', 'plddt', predicted_lddt_loss(
            batch, heads['predicted_lddt'], heads['folding'],
            loss_config.predicted_lddt.config, group))
    # Observability heads (no loss term): TM-score and contact precision.
    for head_name in ('tmscore', 'metric'):
        metrics.update(heads.get(head_name, {}))
    metrics['total'] = total
    return {'loss': total, 'metrics': metrics}
