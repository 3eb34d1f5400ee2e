"""The port's ESM2 conditioning against the JAX package.

f32 on the CPU, `ESM2Config.tiny()`, inputs from numpy.random.default_rng
and dense random weights (`utils/params.dense_random_tree`) handed to both
sides, to the port through the ESM weight bridge.  Tolerances: the ESM2
forward and the attention within 1e-5 of max|ref| (f32 summation order),
trunk activations 1e-4 (as tests/test_torch_modules.py), the sampler
within 0.1 A of backbone per step with identical sequences.  The flash
route's attention alone is held to the JAX package in
tests/test_torch_esm_flash.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import dataset as ds
from abx_tpu.data import features as jax_features
from abx_tpu.data.dataset import DataConfig
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.models import esm as jax_esm
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.models.seqformer import \
    EmbeddingAndSeqformer as JaxEmbeddingAndSeqformer
from abx_tpu.ops import esm_attention as jax_esm_attention
from abx_tpu.sampling.sampler import Sampler as JaxSampler
from abx_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from abx_tpu_torch import config as port_config
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.models.seqformer import EmbeddingAndSeqformer
from abx_tpu_torch.ops import esm_attention as esm_op
from abx_tpu_torch.sampling.sampler import Sampler, SamplerConfig
from abx_tpu_torch.sampling.sampler import to_device_batch
from abx_tpu_torch.utils import params as params_lib
from tests.mini_torch_esm2 import MiniESM2
from tests.test_torch_modules import _force_kernel_route
from tests.torch_cpu_alloc import lean_cpu

REL = 1e-5          # ESM2 and attention, relative to max|ref|
ACT = dict(rtol=0, atol=1e-4)
SEP = 4             # linker length of the small token layouts
ESM_CFG = port_esm.ESM2Config.tiny()
JAX_ESM_CFG = jax_esm.ESM2Config.tiny()


def t(a):
    a = np.asarray(a)
    if a.dtype.kind == 'f':
        return torch.tensor(a, dtype=torch.float32)
    return torch.tensor(a.astype(np.int64))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_rel(got, want, rel=REL, mask=None):
    got, want = n(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _ab_inputs(seed, b=3, l_ab=20):
    """aatype with mixed heavy / light lengths (one chain pair filling
    l_ab, one with padding, one with an X residue)."""
    rng = np.random.default_rng(seed)
    aatype = rng.integers(0, 21, (b, l_ab)).astype(np.int32)
    heavy = np.array([12, 9, 7][:b], np.int32)
    light = np.array([8, 6, 10][:b], np.int32)
    return aatype, heavy, light


def _jax_esm_tree(seed, scan_layers=False, l_esm=30):
    model = jax_esm.ESM2(JAX_ESM_CFG, scan_layers=scan_layers)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, l_esm), jnp.int32)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return params_lib.dense_random_tree(zeros, seed, scale=1.0)


def _port_esm2(tree):
    m = port_esm.ESM2(ESM_CFG, dtype=torch.float32, device='meta')
    params_lib.load_esm_params(m, params_lib.esm_flax_to_state_dict(tree),
                               'cpu', torch.float32)
    return m.eval()


def _tokens(seed):
    aatype, heavy, light = _ab_inputs(seed)
    tokens = np.array(jax_esm.build_esm_tokens(
        jnp.asarray(aatype), jnp.asarray(heavy), jnp.asarray(light), SEP))
    tokens[0, 3] = jax_esm.ESM_MASK      # exercises the token-dropout scale
    return tokens


# --- tokens ------------------------------------------------------------------

def test_build_and_extract_match_jax():
    for seed, sep in ((0, SEP), (1, 48)):
        aatype, heavy, light = _ab_inputs(seed)
        want = np.asarray(jax_esm.build_esm_tokens(
            jnp.asarray(aatype), jnp.asarray(heavy), jnp.asarray(light), sep))
        got = port_esm.build_esm_tokens(t(aatype), t(heavy), t(light), sep)
        np.testing.assert_array_equal(n(got), want)
        rng = np.random.default_rng(seed + 10)
        for shape in ((3, want.shape[1], 5), (3, want.shape[1], 5, 3)):
            reprs = rng.standard_normal(shape).astype(np.float32)
            np.testing.assert_array_equal(
                n(port_esm.extract_antibody_reprs(
                    t(reprs), t(heavy), t(light), aatype.shape[1], sep)),
                np.asarray(jax_esm.extract_antibody_reprs(
                    jnp.asarray(reprs), jnp.asarray(heavy),
                    jnp.asarray(light), aatype.shape[1], sep)))
    assert port_esm.esm2_num_heads(2560) == 40
    assert port_esm.esm2_num_heads(640) == 20
    assert port_esm.ESM2Config.t36_3B() == port_esm.ESM2Config()


# --- attention ---------------------------------------------------------------

def _esm_attention_vs_jax(seed, b, h, l, d, pad, q_scale=1.0):
    """The plain version against `esm_attention_reference` and the Pallas
    kernel in interpret mode, f32; returns the plain output."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32)
               for _ in range(3))
    q *= np.float32(q_scale)
    jargs = [jnp.asarray(a) for a in (q, k, v, pad)]
    want = np.asarray(jax_esm_attention.esm_attention_reference(*jargs))
    interp = np.asarray(jax_esm_attention.esm_attention(*jargs,
                                                        interpret=True))
    got = esm_op.esm_attention_plain(t(q), t(k), t(v), torch.tensor(pad))
    np.testing.assert_allclose(n(got), want, rtol=0, atol=REL)
    np.testing.assert_allclose(n(got), interp, rtol=0, atol=REL)
    return (q, k, v), got


def test_esm_attention_plain_matches_jax_reference_and_interpret():
    b, l = 2, 37
    pad = np.zeros((b, l), bool)
    pad[:, -5:] = True
    pad[1, 7] = True
    (q, k, v), got = _esm_attention_vs_jax(2, b, 3, l, 16, pad)
    # On CPU tensors the wrapper is the plain version and counts nothing.
    before = esm_op.esm_attention.launches
    torch.testing.assert_close(
        esm_op.esm_attention(t(q), t(k), t(v), torch.tensor(pad)), got)
    assert esm_op.esm_attention.launches == before


@pytest.mark.parametrize('shape', [(2, 3, 37, 16, 1), (2, 2, 306, 24, None),
                                   (1, 2, 306, 128, None)])
def test_esm_attention_plain_matches_jax_at_edge_cases(shape):
    """(b, h, l, d, all_pad_row): a batch row whose every key is padded
    (uniform softmax over its L keys on both sides), the ESM2-3B length
    L = 306 at D = 24 (ESM2-35M's head dim, padded to 32 in the kernel) and
    D = 128 (ESM2-15B's, the kernel's largest)."""
    b, h, l, d, all_pad_row = shape
    pad = np.zeros((b, l), bool)
    pad[:, l - 29:] = True
    pad[0, l // 3] = True
    if all_pad_row is not None:
        pad[all_pad_row] = True
    _esm_attention_vs_jax(40 + d, b, h, l, d, pad, q_scale=d ** -0.5)


@pytest.mark.parametrize('route', ['plain', 'kernel', 'flash'])
def test_esm_self_attention_matches_jax(route, monkeypatch):
    """One attention block, through the module's plain route, through its
    kernel route (on_device forced, the wrapper swapped for its plain
    version: head-major strided views in, (B, L, H, D) out) and through
    the flash route (ABX_FUSED_ESM_ATTN=0 ABX_FLASH_ESM=1, likewise),
    checked on the valid rows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 23, ESM_CFG.embed_dim)).astype(np.float32)
    pad = np.zeros((2, 23), bool)
    pad[1, -4:] = True
    jm = jax_esm.ESMSelfAttention(JAX_ESM_CFG)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad)))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 4)
    want = jm.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                    jnp.asarray(pad))
    pm = port_esm.ESMSelfAttention(ESM_CFG, torch.float32)
    pm.load_state_dict({k: torch.tensor(v) for k, v in
                        params_lib.esm_flax_to_state_dict(tree).items()})
    if route == 'flash':
        monkeypatch.setenv('ABX_FUSED_ESM_ATTN', '0')
        monkeypatch.setenv('ABX_FLASH_ESM', '1')
    if route != 'plain':
        _force_kernel_route(monkeypatch)
    cos, sin = port_esm.rotary_sincos(23, ESM_CFG.embed_dim
                                      // ESM_CFG.attention_heads,
                                      torch.float32, 'cpu')
    with torch.no_grad():
        got = pm(t(x), torch.tensor(pad), cos, sin)
    assert_rel(got, want, mask=~pad)


# --- the encoder -------------------------------------------------------------

@pytest.mark.parametrize('layout', ['layer_i', 'stacked'])
def test_esm2_matches_jax_in_all_modes(layout):
    tokens = _tokens(5)
    tree = _jax_esm_tree(6, l_esm=tokens.shape[1])
    scan = layout == 'stacked'
    jm = jax_esm.ESM2(JAX_ESM_CFG, scan_layers=scan)
    jtree = jax_esm.stack_layer_params(tree) if scan else tree
    jtree = jax.tree.map(jnp.asarray, jtree)
    pm = _port_esm2(jax.tree.map(np.asarray, jtree))
    lw = np.random.default_rng(7).random(ESM_CFG.num_layers + 1)
    lw = (lw / lw.sum()).astype(np.float32)
    valid = tokens != jax_esm.ESM_PAD
    jt, pt = jnp.asarray(tokens), t(tokens)
    with torch.no_grad():
        for kwargs in ({}, {'final_only': True}, {'layer_weights': lw}):
            want = jm.apply(jtree, jt, **kwargs)
            pk = dict(kwargs)
            if 'layer_weights' in pk:
                pk['layer_weights'] = t(lw)
            got = pm(pt, **pk)
            assert got.shape == want.shape
            assert_rel(got, want, mask=valid)


def test_fair_esm_checkpoint_loads_and_matches_its_model(tmp_path):
    """A fair-esm `.pt` (tests/mini_torch_esm2.py, with its rotary buffers
    and contact head) through the bridge equals that model's own layers, to
    the bar the JAX converter's test holds (2e-4 relative: f32 summation
    order, and the final LN's eps, 1e-5 there and 1e-6 here)."""
    torch.manual_seed(0)
    mini = MiniESM2(3, 64, 4).eval()
    path = str(tmp_path / 'mini_esm2.pt')
    torch.save({'model': mini.state_dict()}, path)
    sd = params_lib.fair_esm_state_dict(path)
    assert not any('rot_emb' in k or 'contact_head' in k for k in sd)
    pm = port_esm.ESM2(port_esm.ESM2Config(3, 64, 4), device='meta').eval()
    params_lib.load_esm_params(pm, sd, 'cpu', torch.float32)
    tokens = _tokens(8)
    with torch.no_grad():
        want = mini(t(tokens))
        got = pm(t(tokens))
    valid = tokens != jax_esm.ESM_PAD
    for i in range(4):
        assert_rel(got[..., i], want[i], rel=2e-4, mask=valid)
    bad = dict(sd, extra_unknown=torch.zeros(3))
    with pytest.raises(KeyError, match='unexpected'):
        params_lib.load_esm_params(
            port_esm.ESM2(port_esm.ESM2Config(3, 64, 4), device='meta'), bad,
            'cpu', torch.float32)


@pytest.mark.parametrize('fmt', ['pt', 'msgpack'])
def test_build_runtime_loads_esm_checkpoint(fmt, tmp_path):
    """`build_runtime(esm_checkpoint=...)` (the design CLI's
    `--esm_checkpoint`) takes a fair-esm `.pt` or a msgpack of the JAX
    package's ESM2 tree (here the JAX converter's output for the same
    checkpoint), in the compute dtype, and turns ESM conditioning on."""
    from abx_tpu.utils.checkpoint import save_params
    from abx_tpu.utils.torch_convert import convert_esm2_ckpt
    from abx_tpu_torch.cli import runner
    torch.manual_seed(1)
    mini = MiniESM2(3, 64, 4)
    path = str(tmp_path / 'mini_esm2.pt')
    torch.save({'model': mini.state_dict()}, path)
    if fmt == 'msgpack':
        tree = convert_esm2_ckpt(path, num_layers=3)
        path = str(tmp_path / 'mini_esm2.msgpack')
        save_params(path, jax.tree.map(jnp.asarray, tree))
    rt = runner.build_runtime(tiny=True, device='cpu', esm_checkpoint=path,
                              esm_layers=3, esm_dim=64)
    assert rt.config.model.embeddings_and_seqformer.esm.enabled
    assert rt.model.seqformer.esm_embed_weights.shape == (4,)
    got = rt.esm.module.state_dict()
    want = {k: v for k, v in mini.state_dict().items()
            if 'rot_emb' not in k and 'contact_head' not in k}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(n(got[k]), n(v), err_msg=k)


# --- the trunk and the sampler with ESM on -----------------------------------

def _esm_cfgs(l_ab=None, num_recycle=None):
    cfg = jax_config.tiny_model_config()
    pcfg = port_config.tiny_model_config()
    with cfg.unlocked():
        for c in (cfg, pcfg):
            es = c.model.embeddings_and_seqformer.esm
            es.enabled = True
            es.num_layers = ESM_CFG.num_layers
            es.embed_channel = ESM_CFG.embed_dim
            if l_ab:
                c.data.max_antibody_len = l_ab
                c.data.max_antigen_len = 32
            if num_recycle:
                c.model.num_recycle = num_recycle
    return cfg, pcfg


def _esm_pair(l_ab, seed, sep=48):
    """The JAX AntibodyESM (scanned layout) with dense random weights, its
    params, and the port's AntibodyESM with the same weights."""
    jesm = jax_esm.AntibodyESM(JAX_ESM_CFG, l_ab, sep_pad_num=sep,
                               dtype=jnp.float32, scan_layers=True)
    tree = jax_esm.stack_layer_params(_jax_esm_tree(seed))
    pesm = port_esm.AntibodyESM(ESM_CFG, l_ab, sep_pad_num=sep,
                                dtype=torch.float32, device='meta').eval()
    params_lib.load_esm_params(pesm.module,
                               params_lib.esm_flax_to_state_dict(tree),
                               'cpu', torch.float32)
    return jesm, jax.tree.map(jnp.asarray, tree), pesm


def test_embedding_and_seqformer_with_esm_matches_jax():
    cfg, pcfg = _esm_cfgs()
    l_ab, l_ag = 14, 5
    rng = np.random.default_rng(9)
    b, l = 2, l_ab + l_ag
    anchor = np.zeros((b, l_ab), np.int32)
    anchor[:, 3] = anchor[:, 10] = 5
    feats = {
        'seq': rng.integers(0, 20, (b, l)).astype(np.int32),
        'mask': np.ones((b, l), np.float32),
        'atom14_gt_positions': (5.0 * rng.standard_normal((b, l, 14, 3))
                                ).astype(np.float32),
        'atom14_gt_exists': np.ones((b, l, 14), np.float32),
        'cdr_def': rng.integers(0, 14, (b, l)).astype(np.int32),
        'chain_id': np.repeat([[0] * 8 + [1] * 6 + [2] * l_ag], b, 0
                              ).astype(np.int32),
        'residx': np.tile(np.arange(l, dtype=np.int32), (b, 1)),
        'anchor_flag': anchor,
        'heavy_len': np.array([8, 8], np.int32),
        'light_len': np.array([6, 4], np.int32),
    }
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    batch = jax_features.FeatureBuilder()(
        {k: jnp.asarray(v) for k, v in feats.items()})
    batch = jax_features.make_diffuser_features(
        batch, diffuser=jdiff, generate_area='H3', key=jax.random.PRNGKey(1),
        mode='design')
    batch = jax_features.make_static_pair_features(batch)
    batch['t'] = jnp.asarray([0.7, 0.4], jnp.float32)
    es = cfg.model.embeddings_and_seqformer
    prev = {'prev_seq': (b, l, es.seq_channel + es.index_embed_size),
            'prev_pair': (b, l, l, es.pair_channel + 2 * es.index_embed_size)}
    batch.update({k: jnp.asarray(rng.standard_normal(s), jnp.float32)
                  for k, s in prev.items()})
    batch['prev_pos'] = jnp.asarray(
        rng.integers(0, es.prev_pos.num_bins, (b, l, l)), jnp.int32)
    jesm, jesm_params, pesm = _esm_pair(l_ab, 10, sep=SEP)

    def jfn(*a, **kw):
        return jesm(jesm_params, *a, **kw)

    jm = JaxEmbeddingAndSeqformer(es, antibody_len=l_ab)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch,
                                            esm_fn=jfn))
    tree = params_lib.dense_random_tree(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), 11,
        scale=0.5)
    want = jax.jit(lambda p, bt: jm.apply(p, bt, esm_fn=jfn))(
        jax.tree.map(jnp.asarray, tree), batch)
    pm = EmbeddingAndSeqformer(pcfg.model.embeddings_and_seqformer,
                               l_ab).eval()
    params_lib.load_flax_params(pm, tree)
    pb = to_device_batch({k: np.asarray(v) for k, v in batch.items()
                          if not isinstance(v, tuple)}, 'cpu')
    with torch.no_grad():
        got = pm(pb, esm_fn=pesm)
        with pytest.raises(ValueError, match='esm_fn'):
            pm(pb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), **ACT)


@pytest.fixture(scope='module')
def esm_design():
    """The JAX side of the shared-noise ESM design, once for both routes:
    tiny trunk (num_recycle 2) + tiny ESM2, T = 3, on
    testdata/6ct7_H_L_S.pdb at L = 256 + 32; the JAX sampler on the CPU
    takes its einsum attention, whose valid rows both port routes equal.
    Freed memory is kept in the process while it runs (see
    tests/torch_cpu_alloc.py)."""
    num_t, l_ab = 3, 256
    cfg, pcfg = _esm_cfgs(l_ab=l_ab, num_recycle=2)
    ex = ds.complex_from_pdb('testdata/6ct7_H_L_S.pdb', 'H', 'L', ['S'])
    feats, _ = ds.prepare_example(ex, DataConfig(l_ab, 32), False)
    feats = ds.stack_batch([feats, feats])
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jesm, jesm_params, pesm = _esm_pair(l_ab, 12)

    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=l_ab)
    jsampler = JaxSampler(jm, jdiff, cfg.model, JaxSamplerConfig(
        num_t=num_t, mode='design', collect_trajectory=True),
        esm_fn=jesm, esm_params=jesm_params)
    key = jax.random.PRNGKey(0)
    with lean_cpu():
        prepared = jsampler.prepare(jax.random.split(key)[0], jfeats)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), prepared, compute_loss=True,
            esm_fn=lambda *a, **kw: jesm(jesm_params, *a, **kw)))
        tree = params_lib.dense_random_tree(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
            seed=13, scale=0.5)
        b, l = feats['seq'].shape
        rng = np.random.default_rng(14)
        noise = {'rot_z': rng.standard_normal((num_t + 1, b, l, 3)),
                 'trans_z': rng.standard_normal((num_t + 1, b, l, 3)),
                 'seq_u': rng.random((num_t + 1, b, l, 20))}
        noise = {k: v.astype(np.float32) for k, v in noise.items()}
        want = jsampler.sample(
            jax.tree.map(jnp.asarray, tree), jfeats, key,
            noise={k: jnp.asarray(v) for k, v in noise.items()})
        jtraj = jax.tree.map(np.asarray, want['trajectory'])
    return dict(num_t=num_t, l_ab=l_ab, pcfg=pcfg, feats=feats, pesm=pesm,
                prepared={k: np.asarray(v) for k, v in prepared.items()
                          if not isinstance(v, tuple)},
                tree=tree, noise=noise, jtraj=jtraj)


@pytest.mark.parametrize('route', ['default', 'flash'])
def test_esm_design_sampler_matches_jax_under_shared_noise(route, esm_design,
                                                           monkeypatch):
    """The port's ESM-on sampler against the JAX sampler under shared
    noise: ESM runs inside each of the 3 trunk passes of every step, on
    that pass's recycled sequence.  On the default route (esm_attention's
    function) and on the flash route (ABX_FUSED_ESM_ATTN=0
    ABX_FLASH_ESM=1: esm_flash_attention's, whose padded rows differ and
    reach no valid row).  The port's side runs on two torch threads with
    freed memory kept (tests/torch_cpu_alloc.py): in a CPU run of one
    trajectory it took 17 s against 30 s on one thread, and its eight
    threads' 6 s grew 30x beside five busy processes."""
    e = esm_design
    num_t, pcfg, pesm = e['num_t'], e['pcfg'], e['pesm']
    flash_calls = []
    if route == 'flash':
        monkeypatch.setenv('ABX_FUSED_ESM_ATTN', '0')
        monkeypatch.setenv('ABX_FLASH_ESM', '1')
        flash = port_esm.esm_flash_attention
        monkeypatch.setattr(port_esm, 'esm_flash_attention',
                            lambda *a: flash_calls.append(1) or flash(*a))
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    pm = ScoreNetworkIteration(pcfg.model, pdiff, e['l_ab']).eval()
    params_lib.load_flax_params(pm, e['tree'])
    calls = []
    hook = pesm.register_forward_hook(lambda *_: calls.append(1))
    psampler = Sampler(pm, pdiff, pcfg.model,
                       SamplerConfig(num_t=num_t, collect_trajectory=True),
                       esm_fn=pesm)
    batch = to_device_batch(e['prepared'], 'cpu')
    before = esm_op.esm_flash_attention.launches
    try:
        with lean_cpu(threads=2):
            got = psampler.sample_prepared(
                batch, noise={k: torch.tensor(v)
                              for k, v in e['noise'].items()})
    finally:
        hook.remove()
    assert len(calls) == 3 * (num_t + 1)
    assert len(flash_calls) == (len(calls) * ESM_CFG.num_layers
                                if route == 'flash' else 0)
    assert esm_op.esm_flash_attention.launches == before

    jtraj = e['jtraj']
    devs = []
    for s, step in enumerate(got['trajectory']):
        np.testing.assert_array_equal(step['seq'].numpy(), jtraj['seq'][s])
        bb = np.abs(step['atom14'].numpy()[..., :4, :]
                    - jtraj['atom14'][s][..., :4, :])
        devs.append(float(bb.max()))
    print(f'max backbone deviation per step (A), {route} route: {devs}')
    assert max(devs) <= 0.1, devs
    assert not np.array_equal(got['seq'].numpy(), e['feats']['seq'])
