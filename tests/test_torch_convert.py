"""The port's reference-checkpoint converter against the JAX package's.

A port model at a tiny config gets dense random weights W (numpy-seeded,
`utils/params.dense_random_tree`); `utils/torch_convert.reference_state_dict`
writes them under the reference ScoreNetwork's names, as a released
`abx_diffab.ckpt` holds them.  The JAX package's `convert_score_network`
must read every entry of that state dict (none unread, none missing) and,
through `flax_to_state_dict`, give W bit for bit: that holds the helper to
the JAX converter.  The port's converter must give W bit for bit too, and
the port loaded from a `.ckpt` file through `runner.build_runtime` must
compute the JAX network's forward on the JAX-converted tree, in f32, to
1e-5 of max|ref|.  Cases: ESM on and off, SpatialDepthWiseInception
(`inp_kernels`), two Seqformer blocks, and the triangle multiplications
without their gates.
"""

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import features as jax_features
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.utils import checkpoint as jax_ckpt
from abx_tpu.utils import torch_convert as jax_convert
from abx_tpu_torch import config as port_config
from abx_tpu_torch.cli import runner
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models.network import ScoreNetworkIteration, zero_prev
from abx_tpu_torch.utils import params as params_lib
from abx_tpu_torch.utils import torch_convert

L_AB, L_AG = 14, 5
ESM_LAYERS, ESM_DIM = 2, 24
FWD_TOL = 1e-5      # of max|ref|, the JAX forward vs the port's
SDWI = ('seq_attention_with_pair_bias', 'triangle_attention_starting_node',
        'triangle_attention_ending_node', 'triangle_multiplication_outgoing',
        'triangle_multiplication_incoming')
CASES = ['esm_off', 'esm_on', 'sdwi', 'two_blocks', 'no_gates']


def _tweak(cfg, case, unlock=lambda: _Nop()):
    with unlock():
        es = cfg.model.embeddings_and_seqformer
        sf = es.seqformer
        cfg.data.max_antibody_len, cfg.data.max_antigen_len = L_AB, L_AG
        if case == 'esm_on':
            es.esm.enabled = True
            es.esm.num_layers, es.esm.embed_channel = ESM_LAYERS, ESM_DIM
        if case == 'sdwi':
            for name in SDWI:
                sf[name]['inp_kernels'] = [1, 3]
                if 'num_head' not in sf[name]:
                    sf[name]['num_head'] = 4
        if case == 'two_blocks':
            es.seqformer_num_block = 2
        if case == 'no_gates':
            for name in SDWI[3:]:
                sf[name]['gating'] = False
    return cfg


class _Nop:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _port_cfg(case):
    return _tweak(port_config.tiny_model_config(), case)


def _jax_cfg(case):
    cfg = jax_config.tiny_model_config()
    return _tweak(cfg, case, cfg.unlocked)


def _port_model(pcfg):
    diff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    return ScoreNetworkIteration(pcfg.model, diff, L_AB).eval()


@functools.lru_cache(maxsize=None)
def _weights(case):
    """(case, port config, W, the reference-named state dict)."""
    pcfg = _port_cfg(case)
    pm = _port_model(pcfg)
    tree = params_lib.dense_random_tree(params_lib.state_dict_tree(pm),
                                        seed=CASES.index(case), scale=0.5)
    params_lib.load_flax_params(pm, tree)
    w = {k: v.clone() for k, v in pm.state_dict().items()}
    return case, pcfg, w, torch_convert.reference_state_dict(pm)


@pytest.fixture(params=CASES)
def weights(request):
    return _weights(request.param)


def _jax_tree(case, ref):
    sd = jax_convert._TrackedDict({k: v.numpy() for k, v in ref.items()})
    tree = jax_convert.convert_score_network(
        sd, esm_enabled=case == 'esm_on',
        num_blocks=2 if case == 'two_blocks' else 1)
    return tree, sd


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_jax_converter_reads_every_reference_name(weights):
    case, _, w, ref = weights
    tree, sd = _jax_tree(case, ref)
    assert sorted(set(sd) - sd.consumed) == []
    _assert_bitwise(params_lib.flax_to_state_dict(tree), w)
    if case == 'sdwi':
        assert any('.inp_q.convs.0.conv.weight' in k for k in ref)
    if case == 'no_gates':
        assert not any('left_gate' in k for k in ref)


def test_port_converter_gives_the_weights(weights):
    case, pcfg, w, ref = weights
    _assert_bitwise(torch_convert.convert_reference_state_dict(
        {'model_state_dict': ref}, pcfg), w)
    pm = _port_model(pcfg)
    torch_convert.load_reference_state_dict(pm, ref, pcfg)
    _assert_bitwise(pm.state_dict(), w)


def _feats(seed=0, b=2):
    rng = np.random.default_rng(seed)
    l = L_AB + L_AG
    anchor = np.zeros((b, L_AB), np.int32)
    anchor[:, 3] = 5
    anchor[:, 10] = 5
    mask = np.ones((b, l), np.float32)
    mask[1, -1] = 0.0
    cdr = rng.integers(0, 14, (b, l)).astype(np.int32)
    cdr[:, 5:9] = 5            # an H3 to design
    return {
        'seq': rng.integers(0, 20, (b, l)).astype(np.int32),
        'mask': mask,
        'atom14_gt_positions': (5.0 * rng.standard_normal((b, l, 14, 3))
                                ).astype(np.float32),
        'atom14_gt_exists': np.ones((b, l, 14), np.float32),
        'cdr_def': cdr,
        'chain_id': np.concatenate([np.zeros((b, 8)), np.ones((b, 6)),
                                    2 * np.ones((b, L_AG))], 1
                                   ).astype(np.int32),
        'residx': np.tile(np.arange(l, dtype=np.int32), (b, 1)),
        'anchor_flag': anchor,
        'heavy_len': np.full((b,), 8, np.int32),
        'light_len': np.full((b,), 6, np.int32),
    }


def _batch(cfg):
    """The JAX package's design-mode features at t = 0.7 / 0.4, as numpy."""
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    batch = jax_features.FeatureBuilder()(
        {k: jnp.asarray(v) for k, v in _feats().items()})
    batch = jax_features.make_diffuser_features(
        batch, diffuser=jdiff, generate_area='H3', key=jax.random.PRNGKey(1),
        mode='design')
    batch = jax_features.make_static_pair_features(batch)
    t_vec = jnp.asarray([0.7, 0.4], jnp.float32)
    rs, ts = jdiff.score_scaling(t_vec)
    batch.update(t=t_vec, rot_score_scaling=rs, trans_score_scaling=ts)
    return jdiff, {k: np.asarray(v) for k, v in batch.items()
                   if not isinstance(v, tuple)}


def _esm_table():
    """A fixed stand-in for ESM2: per-token (D, layers + 1) embeddings."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((33, ESM_DIM, ESM_LAYERS + 1)).astype(
        np.float32)


def _write_json(path, cfg):
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(cfg.to_dict(), f)


def test_reference_ckpt_forward_matches_jax(weights, tmp_path):
    """One f32 trunk pass (no recycling): the JAX network on the JAX
    converter's tree against the port loaded from a reference `.ckpt`
    through the runner, on the same features.  The rotation score is
    compared on the diffused residues, the only ones the sampler reads:
    elsewhere the frame is the identity and the score is rounding noise
    that the axis term magnifies (PERF.md, open questions)."""
    case, pcfg, w, ref = weights
    tree, _ = _jax_tree(case, ref)
    cfg = _jax_cfg(case)
    jdiff, batch = _batch(cfg)
    table = _esm_table()

    def jesm(tokens, heavy_len, light_len, layer_weights):
        return jnp.einsum('bldn,n->bld', jnp.asarray(table)[tokens],
                          layer_weights)

    def pesm(tokens, heavy_len, light_len, layer_weights):
        return torch.einsum('bldn,n->bld', torch.from_numpy(table)[tokens],
                            layer_weights)

    esm = case == 'esm_on'
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=L_AB)
    want = jax.jit(lambda p, b: jm.apply(p, b, esm_fn=jesm if esm else None,
                                         num_recycle=0))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})

    ckpt = tmp_path / 'abx_diffab.ckpt'
    torch.save({'model_state_dict': ref, 'epoch': 3}, ckpt)
    _write_json(tmp_path / 'config.json', pcfg)
    rt = runner.build_runtime(str(tmp_path / 'config.json'), str(ckpt),
                              device='cpu')
    _assert_bitwise(rt.model.state_dict(), w)
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    pb.update(zero_prev(2, L_AB + L_AG, pcfg.model))
    with torch.no_grad():
        got = rt.model(pb, esm_fn=pesm if esm else None)
    diffused = batch['diffused_mask'] > 0
    assert diffused.any()
    fold, jfold = got['heads']['folding'], want['heads']['folding']
    pairs = {
        'rot_score': (fold['rot_score'].numpy()[diffused],
                      np.asarray(jfold['rot_score'])[diffused]),
        'trans_score': (fold['trans_score'], jfold['trans_score']),
        'atom14': (fold['final_atom14_positions'],
                   jfold['final_atom14_positions']),
        'logits': (got['heads']['sequence_module']['logits'],
                   want['heads']['sequence_module']['logits']),
        'pair': (got['representations']['pair'],
                 want['representations']['pair']),
        'seq': (got['representations']['seq'],
                want['representations']['seq']),
    }
    for name, (g, wnt) in pairs.items():
        g, wnt = np.asarray(g), np.asarray(wnt)
        err, top = np.abs(g - wnt).max(), np.abs(wnt).max()
        assert err <= FWD_TOL * top, (name, err, top)


# --- the runner's routing by content --------------------------------------

def _routes(tmp_path, pcfg, w, ref):
    files = {}
    files['reference'] = tmp_path / 'abx_diffab.ckpt'
    torch.save({'model_state_dict': ref,
                'args': argparse.Namespace(lr=1e-4)}, files['reference'])
    files['reference_bare'] = tmp_path / 'bare.pt'
    torch.save(ref, files['reference_bare'])
    files['port'] = tmp_path / 'params.pt'
    torch.save(w, files['port'])
    files['msgpack'] = tmp_path / 'params.msgpack'
    jax_ckpt.save_params(str(files['msgpack']),
                         jax.tree.map(jnp.asarray, _jax_tree('esm_off',
                                                             ref)[0]))
    return files


def test_runner_routes_by_content(tmp_path):
    """A reference `.ckpt` (with a non-tensor entry: read by the full
    unpickler), a bare reference state dict under a `.pt` name, the port
    trainer's `params.pt` and a JAX msgpack each load W, told apart by
    content."""
    _, pcfg, w, ref = _weights('esm_off')
    want = {'reference': 'reference', 'reference_bare': 'reference',
            'port': 'port', 'msgpack': 'msgpack'}
    files = _routes(tmp_path, pcfg, w, ref)
    for name, path in files.items():
        pm = _port_model(pcfg)
        assert runner.load_trunk_weights(pm, str(path), pcfg) == want[name]
        _assert_bitwise(pm.state_dict(), w)
    pm = _port_model(pcfg)
    torch_convert.convert_reference_ckpt(str(files['reference']), pm, pcfg)
    _assert_bitwise(pm.state_dict(), w)


REF_NAME = ('impl.seqformer.seqformer.blocks.0.'
            'triangle_multiplication_outgoing.proj_out.weight')
PORT_NAME = 'seqformer.seqformer.block_0.tri_mul_out.proj_out.weight'


@pytest.mark.parametrize('fault', ['missing', 'extra', 'shape'])
@pytest.mark.parametrize('kind', ['reference', 'port'])
def test_runner_raises_on_a_key_that_does_not_fit(tmp_path, kind, fault):
    """A file with an entry missing, an extra entry or a wrong shape
    raises, naming the entry."""
    _, pcfg, w, ref = _weights('esm_off')
    sd = dict(ref if kind == 'reference' else w)
    name = REF_NAME if kind == 'reference' else PORT_NAME
    if fault == 'missing':
        del sd[name]
    elif fault == 'extra':
        name = name.replace('proj_out', 'proj_extra')
        sd[name] = torch.zeros(3)
    else:
        sd[name] = torch.zeros(sd[name].shape[0] + 1, sd[name].shape[1])
        name = PORT_NAME          # the check names the port's entry
    path = tmp_path / 'faulty.ckpt'
    torch.save({'model_state_dict': sd} if kind == 'reference' else sd,
               path)
    with pytest.raises((ValueError, RuntimeError)) as e:
        runner.load_trunk_weights(_port_model(pcfg), str(path), pcfg)
    assert name in str(e.value), str(e.value)


@pytest.mark.parametrize('leaf', ['inv_freq', '_float_tensor',
                                  'position_ids', 'num_batches_tracked'])
def test_reference_buffers_without_weight_are_tolerated(tmp_path, leaf):
    """A weightless buffer the map does not read (named in
    `_REFERENCE_NONPARAM_LEAVES`) does not stop the load; W still loads
    bit for bit."""
    _, pcfg, w, ref = _weights('esm_off')
    sd = dict(ref)
    sd[f'impl.seqformer.esm.rot_emb.{leaf}'] = torch.zeros(4)
    path = tmp_path / 'buffers.ckpt'
    torch.save({'model_state_dict': sd}, path)
    pm = _port_model(pcfg)
    assert runner.load_trunk_weights(pm, str(path), pcfg) == 'reference'
    _assert_bitwise(pm.state_dict(), w)


class _MakesDir:
    """Unpickling this runs `os.makedirs(path)`."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        import os
        return os.makedirs, (self.path,)


def test_port_file_is_never_read_by_the_full_unpickler(tmp_path):
    """A torch archive that is no reference checkpoint and holds more than
    tensors is refused with an error naming it, and nothing in it runs."""
    _, pcfg, w, _ = _weights('esm_off')
    marker = tmp_path / 'ran'
    path = tmp_path / 'params.pt'
    torch.save({**w, 'hook': _MakesDir(str(marker))}, path)
    with pytest.raises(RuntimeError, match='unreadable checkpoint') as e:
        runner.load_trunk_weights(_port_model(pcfg), str(path), pcfg)
    assert str(path) in str(e.value)
    assert not marker.exists()


def test_damaged_file_raises_naming_it(tmp_path):
    """A truncated reference checkpoint raises the reader's error naming
    the file; the full unpickler is not tried."""
    _, pcfg, _, ref = _weights('esm_off')
    whole = tmp_path / 'whole.ckpt'
    torch.save({'model_state_dict': ref}, whole)
    path = tmp_path / 'damaged.ckpt'
    data = whole.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(RuntimeError, match='unreadable checkpoint') as e:
        torch_convert.read_checkpoint(str(path))
    assert str(path) in str(e.value)


def test_full_unpickler_warns_naming_the_file(tmp_path, caplog):
    """A reference checkpoint with non-tensor entries is read by the full
    unpickler, with a warning naming the file."""
    _, pcfg, w, ref = _weights('esm_off')
    path = tmp_path / 'abx_rabd.ckpt'
    torch.save({'model_state_dict': ref,
                'args': argparse.Namespace(lr=1e-4)}, path)
    with caplog.at_level('WARNING', logger=torch_convert.__name__):
        state = torch_convert.read_checkpoint(str(path))
    assert state['args'].lr == 1e-4
    assert any(str(path) in r.getMessage() and 'full unpickler'
               in r.getMessage() for r in caplog.records)
