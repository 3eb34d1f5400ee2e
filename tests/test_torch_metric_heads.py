"""The port's metric heads (`abx_tpu_torch/models/metric_heads.py`) against
the JAX package's (`abx_tpu/models/metric_heads.py`).

f32 on the CPU, inputs from numpy.random.default_rng, every result within
1e-5 (absolute on the TM-scores and precisions, which lie in [0, 1];
relative to max|ref| on aligned coordinates).  The Kabsch inputs are
non-degenerate (random clouds of full rank with distinct singular values
of the covariance), where the optimal rotation is unique and both SVDs
must give it; degenerate clouds are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.models import metric_heads as jax_mh
from abx_tpu_torch.models import metric_heads as port_mh

TOL = 1e-5


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _clouds(seed, b=3, l=40, noise=1.5):
    rng = np.random.default_rng(seed)
    gt = (rng.standard_normal((b, l, 3)) * [7.0, 5.0, 3.0]).astype(
        np.float32)
    pred = gt + (rng.standard_normal((b, l, 3)) * noise).astype(np.float32)
    # A rotated, shifted copy, so the alignment has work to do.
    ang = 0.7
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    pred = (pred @ rot.T + [4.0, -2.0, 1.0]).astype(np.float32)
    mask = (rng.random((b, l)) > 0.2).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize('weighted', [False, True])
def test_weighted_kabsch_matches_jax(weighted):
    pred, gt, mask = _clouds(0)
    w = mask[0] * (np.random.default_rng(1).random(40) if weighted else 1.0)
    want = np.asarray(jax_mh.weighted_kabsch(
        jnp.asarray(pred[0]), jnp.asarray(gt[0]),
        jnp.asarray(w, jnp.float32)))
    got = port_mh.weighted_kabsch(t(pred[0]), t(gt[0]), t(w)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # The batched call gives each example's alignment.
    batched = port_mh.weighted_kabsch(t(pred), t(gt), t(mask)).numpy()
    for i in range(len(pred)):
        one = np.asarray(jax_mh.weighted_kabsch(
            jnp.asarray(pred[i]), jnp.asarray(gt[i]), jnp.asarray(mask[i])))
        assert np.abs(batched[i] - one).max() <= TOL * np.abs(one).max()


@pytest.mark.parametrize('noise', [0.0, 1.5, 6.0])
def test_tm_score_matches_jax(noise):
    pred, gt, mask = _clouds(2, noise=noise)
    want = np.asarray(jax_mh.tm_score(jnp.asarray(pred), jnp.asarray(gt),
                                      jnp.asarray(mask)))
    got = port_mh.tm_score(t(pred), t(gt), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _contacts(seed, b=2, l=48):
    rng = np.random.default_rng(seed)
    coords = rng.standard_normal((b, l, 3)) * 6
    truth = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    pred = 1.0 / (1.0 + truth) + rng.random((b, l, l)) * 0.1
    mask = (rng.random((b, l)) > 0.1).astype(np.float32)
    return pred, truth, mask


@pytest.mark.parametrize('ranges', [jax_mh.CONTACT_RANGES,
                                    ((0, 6), (6, None))])
def test_contact_precision_matches_jax(ranges):
    pred, truth, mask = _contacts(3)
    want = jax_mh.contact_precision(
        jnp.asarray(pred, jnp.float32), jnp.asarray(truth, jnp.float32),
        jnp.asarray(mask), ranges=ranges)
    got = port_mh.contact_precision(t(pred), t(truth), t(mask),
                                    ranges=ranges)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def _heads_batch(seed, b=2, l=32, bins=16):
    rng = np.random.default_rng(seed)
    batch = {
        'pseudo_beta': rng.standard_normal((b, l, 3)) * 6,
        'pseudo_beta_mask': (rng.random((b, l)) > 0.1).astype(np.float32),
        'mask': np.ones((b, l), np.float32),
        'atom14_gt_positions': rng.standard_normal((b, l, 14, 3)) * 6,
        'atom14_gt_exists': np.ones((b, l, 14), np.float32),
    }
    disto = {'logits': rng.standard_normal((b, l, l, bins)),
             'breaks': np.linspace(2.0, 22.0, bins - 1)}
    fold = {'final_atom14_positions': batch['atom14_gt_positions']
            + rng.standard_normal((b, l, 14, 3))}
    return disto, batch, fold


def test_metric_dict_head_matches_jax():
    disto, batch, _ = _heads_batch(4)
    cfg = {'contact_cutoff': 8.0}
    want = jax_mh.metric_dict_head(
        {k: jnp.asarray(v, jnp.float32) for k, v in disto.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}, cfg)
    got = port_mh.metric_dict_head({k: t(v) for k, v in disto.items()},
                                   {k: t(v) for k, v in batch.items()}, cfg)
    assert set(got) == set(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_tmscore_head_matches_jax():
    _, batch, fold = _heads_batch(5)
    want = jax_mh.tmscore_head(
        {k: jnp.asarray(v, jnp.float32) for k, v in fold.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()})
    x = t(fold['final_atom14_positions']).requires_grad_(True)
    got = port_mh.tmscore_head({'final_atom14_positions': x},
                               {k: t(v) for k, v in batch.items()})
    assert not got['tmscore'].requires_grad       # stop_gradient
    np.testing.assert_allclose(float(got['tmscore']),
                               float(want['tmscore']), rtol=0, atol=TOL)
