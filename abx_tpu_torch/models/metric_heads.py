"""Training-time metric heads: TM-score and contact precision.

Counterpart of `abx_tpu/models/metric_heads.py`.  Parity surface: the
reference's abx/model/head.py:82-141 (MetricDictHead, TMscoreHead) backed
by abx/utils.py (Kabsch :412, TMscore :562, contact_precision :765).  Both
are parameter-free observability heads run only on `compute_loss=True`
passes (`models/network.py`); their outputs land in the trainer's
metrics dict.

As in the JAX package: the per-example Kabsch is batched (one batched 3x3
SVD with the determinant sign fix, in place of the JAX `vmap`), and the
top-k contacts are a masked `torch.topk` with a static k per ratio.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

# Reference defaults (abx/utils.py:821-825).
CONTACT_RATIOS = (1.0, 0.5, 0.2, 0.1)
CONTACT_RANGES = ((6, 12), (12, 24), (24, None))
CONTACT_CUTOFF = 8.0


def weighted_kabsch(mobile: torch.Tensor, target: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Optimal-rotation alignment of `mobile` onto `target`.

    Args:
        mobile/target: (..., L, 3); weights: (..., L) nonnegative.
    Returns: aligned mobile coords (..., L, 3).
    """
    w = weights[..., None] / (torch.sum(weights, -1)[..., None, None]
                              + 1e-8)
    mu_m = torch.sum(mobile * w, dim=-2, keepdim=True)
    mu_t = torch.sum(target * w, dim=-2, keepdim=True)
    a = (mobile - mu_m) * w
    b = target - mu_t
    cov = a.transpose(-1, -2) @ b
    u, _, vt = torch.linalg.svd(cov, full_matrices=False)
    det = torch.linalg.det(u @ vt)
    d = torch.ones(cov.shape[:-1], dtype=cov.dtype, device=cov.device)
    d = torch.cat([d[..., :2], det[..., None]], dim=-1)
    rot = (u * d[..., None, :]) @ vt
    return (mobile - mu_m) @ rot + mu_t


def tm_score(pred_ca: torch.Tensor, gt_ca: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked TM-score after Kabsch alignment (TMscoreHead, head.py:116).

    Args: pred_ca/gt_ca (B, L, 3); mask (B, L).  Returns (B,).
    """
    p, g, m = pred_ca.float(), gt_ca.float(), mask.float()
    aligned = weighted_kabsch(p, g, m)
    n = torch.sum(m, -1)
    big_l = torch.clamp(n, min=21.0)
    d0 = 1.24 * torch.pow(big_l - 15.0, 1.0 / 3.0) - 1.8
    d2 = torch.sum(torch.square(aligned - g), dim=-1)
    per = 1.0 / (1.0 + d2 / torch.square(d0)[:, None])
    return torch.sum(per * m, -1) / (n + 1e-8)


def contact_precision(pred: torch.Tensor, truth: torch.Tensor,
                      mask: torch.Tensor,
                      ratios: Sequence[float] = CONTACT_RATIOS,
                      ranges: Sequence[Tuple] = CONTACT_RANGES,
                      cutoff: float = CONTACT_CUTOFF
                      ) -> Dict[str, torch.Tensor]:
    """Top-k contact precision per sequence-separation range.

    Args:
        pred: (B, L, L) predicted contact probability.
        truth: (B, L, L) true distances.
        mask: (B, L) residue mask.
    Returns: {'[i,j)_r': (B,) precision} for each range x ratio.
    """
    b, l, _ = pred.shape
    dev = pred.device
    pair_mask = mask[:, :, None] * mask[:, None, :]
    pos = torch.arange(l, device=dev)
    sep = torch.abs(pos[:, None] - pos[None, :])
    correct = ((truth > 0) & (truth < cutoff)).float()

    out = {}
    for lo, hi in ranges:
        lo_v = lo if lo is not None else 0
        hi_v = hi if hi is not None else l
        rng = ((sep >= lo_v) & (sep < hi_v))[None]
        valid = pair_mask * rng
        # Masked entries sort to the bottom; their labels count as wrong.
        scores = torch.where(valid > 0, pred,
                             torch.full_like(pred, -torch.inf)).reshape(b, -1)
        labels = (correct * valid).reshape(b, -1)
        k_max = max(1, int(l * max(ratios)))
        _, top_idx = torch.topk(scores, k_max, dim=-1)
        top_labels = torch.gather(labels, -1, top_idx)
        csum = torch.cumsum(top_labels, dim=-1)
        for ratio in ratios:
            k = max(1, int(l * ratio))
            name = f'[{lo_v},{hi if hi is not None else "inf"})_{ratio}'
            out[name] = csum[:, k - 1] / float(k)
    return out


def metric_dict_head(distogram: Dict, batch: Dict, config: Any
                     ) -> Dict[str, torch.Tensor]:
    """Contact-precision metrics from the distogram head (head.py:82-114)."""
    logits = distogram['logits'].float()
    breaks = distogram['breaks']
    cutoff = _get(config, 'contact_cutoff', CONTACT_CUTOFF)
    t = torch.sum((breaks <= cutoff).long())
    prob = torch.softmax(logits, dim=-1)
    # P(contact) = mass below the cutoff bin (head.py:100-101).
    below = torch.arange(prob.shape[-1], device=prob.device) <= t
    pred = torch.sum(prob * below, dim=-1)
    pb = batch['pseudo_beta']
    truth = torch.sqrt(torch.sum(
        torch.square(pb[:, :, None] - pb[:, None, :]), dim=-1) + 1e-10)
    mask = batch['pseudo_beta_mask'] * batch['mask']
    prec = contact_precision(
        pred, truth, mask,
        ratios=_get(config, 'contact_ratios', CONTACT_RATIOS),
        ranges=_get(config, 'contact_ranges', CONTACT_RANGES),
        cutoff=cutoff)
    return {f'contact/{k}': torch.mean(v) for k, v in prec.items()}


def tmscore_head(folding: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
    """Batch-mean CA TM-score vs ground truth (head.py:116-141)."""
    pred = folding['final_atom14_positions'][..., 1, :].detach()
    gt = batch['atom14_gt_positions'][..., 1, :]
    mask = batch['atom14_gt_exists'][..., 1] * batch['mask']
    return {'tmscore': torch.mean(tm_score(pred, gt, mask))}


def _get(config, key, default):
    if config is None:
        return default
    get = getattr(config, 'get', None)
    if get is not None:
        return get(key, default)
    return getattr(config, key, default)
