"""The port's masked-LM head and masked pseudo-log-likelihood against the
JAX package's (`abx_tpu/models/esm.py::ESM2LMHead`,
`abx_tpu/evaluation/pll.py`, `abx_tpu/cli/eval_pll.py`).

f32 on the CPU, `ESM2Config.tiny()`, dense random weights
(`utils/params.dense_random_tree`) handed to both sides, to the port
through the ESM weight bridge (the LM head under `lm_head.`).
Tolerances: the LM head's logits within 1e-5 of max|ref|; the mean PLL
of a 40-residue chain (two batches of masked copies, 32 + 8) within
1e-5 absolute; the PLL CLI's rows (a fair-esm `.pt` built from
tests/mini_torch_esm2.py's state dict with the `lm_head.*` keys added
here, on a complex whose chains H and L are cut to 40 and 20 residues)
within 1e-5 absolute, every other column equal.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.cli import eval_pll as jax_eval_pll
from abx_tpu.evaluation import pll as jax_pll
from abx_tpu.models import esm as jax_esm
from abx_tpu_torch.cli import eval_pll as port_eval_pll
from abx_tpu_torch.data.pdb_io import ChainData
from abx_tpu_torch.evaluation import pll as port_pll
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.evaluation.trajectory import \
    _write_chains_pdb as write_chains_pdb
from abx_tpu_torch.utils import params as params_lib
from tests.mini_torch_esm2 import MiniESM2
from tests.test_torch_eval_tools import (designed_chains, read_csv_rows,
                                         run_jax_cli)

CFG, JAX_CFG = port_esm.ESM2Config.tiny(), jax_esm.ESM2Config.tiny()
TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(model, seed, *args, **kwargs):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               **kwargs))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return params_lib.dense_random_tree(zeros, seed)


@pytest.fixture(scope='module')
def trees():
    """Dense random JAX trees of the tiny ESM2 encoder and its LM head."""
    enc = _random(jax_esm.ESM2(JAX_CFG), 0, jnp.zeros((1, 42), jnp.int32))
    head = _random(jax_esm.ESM2LMHead(JAX_CFG), 1,
                   jnp.zeros((1, 42, JAX_CFG.embed_dim)),
                   embed_weight=jnp.zeros((33, JAX_CFG.embed_dim)))
    return enc, head


def _port_models(enc, head):
    state = params_lib.esm_flax_to_state_dict(
        {'params': {**enc['params'], 'lm_head': head['params']}})
    assert params_lib.has_lm_head(state)
    model = port_esm.ESM2(CFG, device='meta')
    params_lib.load_esm_params(model, state, 'cpu', torch.float32)
    lm = port_esm.ESM2LMHead(CFG, device='meta')
    params_lib.load_lm_head_params(lm, state, 'cpu', torch.float32)
    return model.eval(), lm


def test_lm_head_matches_jax(trees):
    enc, head = trees
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 7, CFG.embed_dim)).astype(np.float32)
    embed = enc['params']['embed_tokens']['embedding']
    want = np.asarray(jax_esm.ESM2LMHead(JAX_CFG).apply(
        jax.tree.map(jnp.asarray, head), jnp.asarray(feats),
        embed_weight=jnp.asarray(embed)))
    _, lm = _port_models(enc, head)
    assert lm.layer_norm.eps == 1e-6           # flax's default, as JAX
    with torch.no_grad():
        got = lm(torch.tensor(feats), torch.tensor(embed)).numpy()
    assert got.shape == want.shape == (2, 7, 33)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_masked_pll_matches_jax(trees):
    enc, head = trees
    seq = ''.join(np.random.default_rng(3).choice(
        list('ACDEFGHIKLMNPQRSTVWY'), 40))
    jenc = jax.tree.map(jnp.asarray, enc)
    jhead = jax.tree.map(jnp.asarray, head)
    embed = jenc['params']['embed_tokens']['embedding']
    lm = jax_esm.ESM2LMHead(JAX_CFG)
    # masked_pll calls `esm_model.apply(params, tokens, final_only=True)`:
    # the same ESM2 apply, jitted (one compile a batch shape).
    jitted = types.SimpleNamespace(apply=jax.jit(
        jax_esm.ESM2(JAX_CFG).apply, static_argnames=['final_only']))
    want = jax_pll.masked_pll(
        jitted, jenc, lambda f: lm.apply(jhead, f, embed_weight=embed), seq)
    model, plm = _port_models(enc, head)
    calls = []

    def head_fn(f):
        calls.append(f.shape)
        return plm(f, model.embed_tokens.weight)
    got = port_pll.masked_pll(model, head_fn, seq)
    assert calls == [(32, 42, CFG.embed_dim), (8, 42, CFG.embed_dim)]
    assert got < 0.0 and abs(got - want) <= TOL, (got, want)


def _fair_esm_pt(path):
    """A fair-esm `.pt` with the masked-LM head: MiniESM2's state dict plus
    the `lm_head.*` entries fair-esm saves (the projection tied to the
    token embedding)."""
    torch.manual_seed(0)
    mini = MiniESM2(3, 64, 4)
    sd = dict(mini.state_dict())
    g = torch.Generator().manual_seed(1)
    sd['lm_head.dense.weight'] = torch.randn(64, 64, generator=g) / 8.0
    sd['lm_head.dense.bias'] = 0.1 * torch.randn(64, generator=g)
    sd['lm_head.layer_norm.weight'] = 1 + 0.1 * torch.randn(64, generator=g)
    sd['lm_head.layer_norm.bias'] = 0.1 * torch.randn(64, generator=g)
    sd['lm_head.weight'] = sd['embed_tokens.weight'].clone()
    sd['lm_head.bias'] = 0.1 * torch.randn(33, generator=g)
    torch.save({'model': sd}, path)
    return sd


def _short_chains_dir(root):
    """A design directory whose complex has short antibody chains: H of 40
    residues (a batch of 32 masked copies and one of 8), L of 20 (one
    batch of 20).  The PLL CLI scores whatever chains H and L hold."""
    chains = designed_chains(0)
    short = [ChainData(c.chain_id, c.str_seq[:n], c.coords[:n],
                       c.coord_mask[:n], c.resseq[:n], c.icodes[:n])
             for c, n in zip(chains, (40, 20, 10))]
    os.makedirs(os.path.join(root, '0000'))
    write_chains_pdb(os.path.join(root, '0000', '6ct7_H_L_S.pdb'), short)
    return str(root)


def test_eval_pll_cli_matches_jax(tmp_path, monkeypatch):
    pt = str(tmp_path / 'mini_esm2.pt')
    sd = _fair_esm_pt(pt)
    state = params_lib.fair_esm_state_dict(pt)
    assert {k for k in state if k.startswith('lm_head.')} == {
        k for k in sd if k.startswith('lm_head.')}
    data = _short_chains_dir(tmp_path / 'design')
    outs = [str(tmp_path / f'pll{i}.csv') for i in range(2)]
    shape = ['--num_layers', '3', '--embed_dim', '64', '--num_heads', '4']
    port_eval_pll.main(['--data_dir', data, '--esm_checkpoint', pt,
                        '--output_csv', outs[0], '--device', 'cpu'] + shape)
    run_jax_cli(monkeypatch, jax_eval_pll.main,
                ['--data_dir', data, '--esm_checkpoint', pt,
                 '--output_csv', outs[1]] + shape)
    got, want = (read_csv_rows(o) for o in outs)
    assert [(r['name'], r['chain'], r['file']) for r in got] == \
        [(r['name'], r['chain'], r['file']) for r in want]
    assert [r['chain'] for r in got] == ['H', 'L']
    for g, w in zip(got, want):
        assert abs(float(g['pll']) - float(w['pll'])) <= TOL, (g, w)


def test_eval_pll_cli_needs_the_lm_head(tmp_path):
    torch.manual_seed(0)
    pt = str(tmp_path / 'encoder_only.pt')
    torch.save({'model': MiniESM2(3, 64, 4).state_dict()}, pt)
    data = _short_chains_dir(tmp_path / 'design')
    with pytest.raises(SystemExit, match='no lm_head'):
        port_eval_pll.main(['--data_dir', data, '--esm_checkpoint', pt,
                            '--num_layers', '3', '--embed_dim', '64',
                            '--num_heads', '4', '--device', 'cpu'])
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match='--device cuda'):
            port_eval_pll.main(['--data_dir', data, '--esm_checkpoint', pt])
