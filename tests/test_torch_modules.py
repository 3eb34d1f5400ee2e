"""The port's modules against the JAX package at tiny_model_config().

Inputs come from numpy.random.default_rng; weights are dense random trees
of the JAX modules' shapes (`utils/params.dense_random_tree`, so no layer
hides behind an AF2 zero init), handed to both sides, to the port through
the weight bridge.  Everything runs in f32 on the CPU.  Tolerances:
1e-4 absolute for activations, 1e-3 A for coordinates.

The kernel routes are also exercised here: with `registry.on_device`
forced true and each kernel wrapper swapped for its plain version, the
modules take their kernel wiring (weight regrouping and stacking,
orientation swaps, the pair-bias layout, the recycled pair-input assembly);
that must equal the plain module path.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu import config as jax_config
from abx_tpu.data import features as jax_features
from abx_tpu.diffusion.joint import JointConfig as JaxJointConfig
from abx_tpu.diffusion.joint import JointDiffuser as JaxJointDiffuser
from abx_tpu.geometry import frames as jax_frames
from abx_tpu.geometry import quat as jax_quat
from abx_tpu.models import heads as jax_heads
from abx_tpu.models.ipa import IpaScore as JaxIpaScore
from abx_tpu.models.network import ScoreNetwork as JaxScoreNetwork
from abx_tpu.models.seqformer import SeqformerIteration as JaxBlock
from abx_tpu_torch import config as port_config
from abx_tpu_torch.data import features as port_features
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.geometry import frames as port_frames
from abx_tpu_torch.geometry import quat as port_quat
from abx_tpu_torch.models import heads as port_heads
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models import ipa as port_ipa
from abx_tpu_torch.models import seqformer as port_seqformer
from abx_tpu_torch.models.ipa import IpaScore
from abx_tpu_torch.models.network import (ScoreNetworkIteration,
                                          forward_with_recycling, zero_prev)
from abx_tpu_torch.models.seqformer import SeqformerIteration
from abx_tpu_torch.ops import (esm_attention, esm_layer_norm, gate_proj,
                               ipa_attend, ipa_attention, pair_bias,
                               recycle_embed, registry, transition,
                               tri_attention, tri_mult, triangle)
from abx_tpu_torch.utils import params as params_lib

ACT = dict(rtol=0, atol=1e-4)
COORD = dict(rtol=0, atol=1e-3)
L_AB, L_AG = 14, 5          # odd L = 19


def t(a):
    a = np.asarray(a)
    if a.dtype.kind == 'f':
        return torch.tensor(a, dtype=torch.float32)
    return torch.tensor(a.astype(np.int64))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _feats(seed=0, b=2):
    rng = np.random.default_rng(seed)
    l = L_AB + L_AG
    anchor = np.zeros((b, L_AB), np.int32)
    anchor[:, 3] = 5
    anchor[:, 10] = 5
    mask = np.ones((b, l), np.float32)
    mask[1, -1] = 0.0
    return {
        'seq': rng.integers(0, 20, (b, l)).astype(np.int32),
        'mask': mask,
        'atom14_gt_positions': (5.0 * rng.standard_normal((b, l, 14, 3))
                                ).astype(np.float32),
        'atom14_gt_exists': np.ones((b, l, 14), np.float32),
        'cdr_def': rng.integers(0, 14, (b, l)).astype(np.int32),
        'chain_id': np.concatenate([np.zeros((b, 8)), np.ones((b, 6)),
                                    2 * np.ones((b, L_AG))], 1
                                   ).astype(np.int32),
        'residx': np.tile(np.arange(l, dtype=np.int32), (b, 1)),
        'anchor_flag': anchor,
    }


def _np_batch(batch):
    """JAX batch -> numpy arrays (Rigid tuples dropped)."""
    return {k: np.asarray(v) for k, v in batch.items()
            if not isinstance(v, tuple)}


@pytest.fixture(scope='module')
def setup():
    cfg = jax_config.tiny_model_config()
    jdiff = JaxJointDiffuser(JaxJointConfig.from_dict(cfg.diffuser.to_dict()))
    pcfg = port_config.tiny_model_config()
    pdiff = JointDiffuser(JointConfig.from_dict(pcfg.diffuser.to_dict()))
    feats = {k: jnp.asarray(v) for k, v in _feats().items()}
    batch = jax_features.FeatureBuilder()(feats)
    batch = jax_features.make_diffuser_features(
        batch, diffuser=jdiff, generate_area='H3', key=jax.random.PRNGKey(1),
        mode='design')
    batch = jax_features.make_static_pair_features(batch)
    b = batch['seq'].shape[0]
    t_vec = jnp.asarray([0.7, 0.4], jnp.float32)[:b]
    rs, ts = jdiff.score_scaling(t_vec)
    batch.update(t=t_vec, rot_score_scaling=rs, trans_score_scaling=ts)
    return cfg, jdiff, pcfg, pdiff, _np_batch(batch)


def _dense(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return params_lib.dense_random_tree(zeros, seed, scale=0.5)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _force_kernel_route(monkeypatch):
    """Send the modules down their kernel routes on the CPU: `on_device`
    forced true, and each wrapper (which would then launch its kernel)
    swapped for its plain version."""
    monkeypatch.setattr(registry, 'on_device', lambda x: True)
    for module, name, plain in (
            (port_seqformer, 'pair_bias_proj',
             pair_bias.pair_bias_proj_plain),
            (port_seqformer, 'triangle_attention_packed',
             tri_attention.triangle_attention_packed_plain),
            (port_seqformer, 'fused_transition',
             transition.fused_transition_plain),
            (port_seqformer, 'tri_mult_pre', tri_mult.tri_mult_pre_plain),
            (port_seqformer, 'tri_mult_post', tri_mult.tri_mult_post_plain),
            (port_seqformer, 'recycle_embed',
             recycle_embed.recycle_embed_plain),
            (port_ipa, 'ipa_attention', ipa_attention.ipa_attention_plain),
            (port_esm, 'esm_attention', esm_attention.esm_attention_plain),
            (port_esm, 'esm_flash_attention',
             esm_attention.esm_flash_attention_plain),
            (port_esm, 'esm_layer_norm', esm_layer_norm.esm_layer_norm_plain),
            (port_seqformer, 'gate_proj_residual',
             gate_proj.gate_proj_residual_plain),
            (port_seqformer, 'tri_mult_post_gatefold',
             tri_mult.tri_mult_post_gatefold_plain),
            (triangle, 'triangle_multiply_kernel',
             triangle.triangle_multiply_einsum),
            (port_ipa, 'ipa_pair_attend', ipa_attend.ipa_pair_attend_plain)):
        monkeypatch.setattr(module, name, plain)


# --- config, imports, bridge -------------------------------------------------

def test_config_matches_jax():
    for jc, pc in ((jax_config.tiny_model_config(),
                    port_config.tiny_model_config()),
                   (jax_config.load_config('config/config_model.json'),
                    port_config.load_config('config/config_model.json'))):
        want = jc.to_dict()
        got = pc.to_dict()
        for key in ('model', 'diffuser', 'data'):
            assert got[key] == want[key], key


def test_port_imports_no_jax():
    code = ('import sys; import abx_tpu_torch.cli.design; '
            'bad = [m for m in ("jax", "flax", "ml_collections", "abx_tpu") '
            'if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_msgpack_bridge_roundtrip(tmp_path):
    from abx_tpu.utils.checkpoint import save_params
    tree = {'params': {'impl': {'a': {'kernel': np.arange(6, dtype=np.float32)
                                      .reshape(2, 3),
                                      'bias': np.ones(3, np.float32)},
                                'n': {'scale': np.full(4, 2.0, np.float32)}}}}
    path = str(tmp_path / 'p.msgpack')
    save_params(path, _jtree(tree))
    state = params_lib.flax_to_state_dict(params_lib.read_msgpack(path))
    assert set(state) == {'a.weight', 'a.bias', 'n.scale'}
    np.testing.assert_array_equal(n(state['a.weight']),
                                  tree['params']['impl']['a']['kernel'].T)
    np.testing.assert_array_equal(n(state['n.scale']), np.full(4, 2.0))


# --- geometry ------------------------------------------------------------------

def test_geometry_matches_jax(setup):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    for jf, pf, args in (
            (jax_quat.quat_to_rot, port_quat.quat_to_rot, (q,)),
            (jax_quat.quat_to_rotvec, port_quat.quat_to_rotvec, (q,)),
            (jax_quat.rotvec_to_quat, port_quat.rotvec_to_quat, (v,)),
            (jax_quat.quat_precompose_vec, port_quat.quat_precompose_vec,
             (q, 0.1 * v)),
            (jax_quat.rot_to_quat, port_quat.rot_to_quat,
             (np.asarray(jax_quat.quat_to_rot(q)),))):
        np.testing.assert_allclose(
            n(pf(*[t(a) for a in args])),
            np.asarray(jf(*[jnp.asarray(a) for a in args])), rtol=0,
            atol=1e-5)
    feats = _feats(4)
    jb = jax_features.FeatureBuilder()({k: jnp.asarray(v)
                                        for k, v in feats.items()})
    pb = port_features.FeatureBuilder()({k: t(v) for k, v in feats.items()})
    for key in ('atom37_gt_positions', 'torsion_angles_sin_cos',
                'torsion_angles_mask', 'pseudo_beta',
                'left_gt_calpha3_frame_positions'):
        np.testing.assert_allclose(n(pb[key]), np.asarray(jb[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(
        n(pb['rigidgroups_gt_frames'].trans),
        np.asarray(jb['rigidgroups_gt_frames'].trans), **COORD)
    np.testing.assert_allclose(
        n(pb['rigidgroups_gt_frames'].rot),
        np.asarray(jb['rigidgroups_gt_frames'].rot), rtol=0, atol=1e-5)
    pos = np.asarray(jb['atom37_gt_positions'])
    np.testing.assert_array_equal(
        n(port_frames.dgram_from_positions(
            port_frames.pseudo_beta_virtual(t(pos)), 15, 3.375, 21.375)),
        np.asarray(jax_frames.dgram_from_positions(
            jax_frames.pseudo_beta_virtual(jnp.asarray(pos)), 15, 3.375,
            21.375)))
    ps = port_features.make_static_pair_features(dict(pb))
    js = jax_features.make_static_pair_features(dict(jb))
    for key in ('static_pair_dist2', 'static_pseudo_beta_fixed'):
        np.testing.assert_allclose(n(ps[key]), np.asarray(js[key]),
                                   rtol=1e-5, atol=1e-4)


def test_design_features_masks_match_jax(setup):
    """Design-mode masks (incl. the CDR-slice quirk) and the imputed fixed
    residues; the noisy draws come from different generators."""
    cfg, jdiff, pcfg, pdiff, batch = setup
    feats = _feats()
    pb = port_features.FeatureBuilder()({k: t(v) for k, v in feats.items()})
    pb = port_features.make_diffuser_features(
        pb, diffuser=pdiff, generate_area='H3',
        generator=torch.Generator().manual_seed(0))
    for key in ('fixed_mask', 'diffused_mask', 'struc_loss_mask'):
        np.testing.assert_array_equal(n(pb[key]), batch[key], err_msg=key)
    fixed = batch['fixed_mask'] > 0
    np.testing.assert_allclose(n(pb['rigids_t'])[fixed],
                               batch['rigids_t'][fixed], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(pb['seq_t'])[fixed],
                                  batch['seq_t'][fixed])


def test_cdr_subset_law_training_mode():
    """Training augmentation: every diffused residue lies inside a jittered
    window of a CDR present in the complex, and the subset is non-empty."""
    rng = np.random.default_rng(5)
    anchor = np.zeros((64, 40), np.int64)
    for e, (a, b) in zip((1, 3, 5), ((2, 9), (14, 20), (25, 33))):
        anchor[:, a] = e
        anchor[:, b] = e
    anchor[:32, 14] = anchor[:32, 20] = 0       # H2 absent in half
    got = n(port_features.select_cdrs_mask(
        t(anchor), 40, [1, 3, 5], torch.zeros(64, 45),
        generator=torch.Generator().manual_seed(int(rng.integers(1 << 30)))))
    assert got.shape == (64, 45)
    assert (got.sum(-1) > 0).all()
    assert got[:32, 13:22].sum() == 0
    allowed = np.zeros(45, bool)
    for a, b in ((2, 9), (14, 20), (25, 33)):
        allowed[a - 1:b + 1] = True
    assert not got[:, ~allowed].any()


# --- diffusion -------------------------------------------------------------------

def test_reverse_step_matches_jax_under_injected_noise(setup):
    cfg, jdiff, pcfg, pdiff, batch = setup
    rng = np.random.default_rng(6)
    b, l = batch['seq'].shape
    rigids = batch['rigids_t']
    noise = {'rot_z': rng.standard_normal((b, l, 3)).astype(np.float32),
             'trans_z': rng.standard_normal((b, l, 3)).astype(np.float32),
             'seq_u': rng.random((b, l, 20)).astype(np.float32)}
    rot_score = (0.5 * rng.standard_normal((b, l, 3))).astype(np.float32)
    trans_score = (0.5 * rng.standard_normal((b, l, 3))).astype(np.float32)
    logits = (3.0 * rng.standard_normal((b, l, 20))).astype(np.float32)
    dmask = (1 - batch['fixed_mask']).astype(np.float32)
    tv = np.asarray([0.6, 0.3], np.float32)
    jr, js = jdiff.reverse(
        jax.random.PRNGKey(0), jnp.asarray(rigids), jnp.asarray(batch['seq_t']),
        jnp.asarray(rot_score), jnp.asarray(trans_score), jnp.asarray(logits),
        jnp.asarray(tv), jnp.float32(0.05), diffuse_mask=jnp.asarray(dmask),
        noise={k: jnp.asarray(v) for k, v in noise.items()})
    pr, ps = pdiff.reverse(
        None, t(rigids), t(batch['seq_t']), t(rot_score), t(trans_score),
        t(logits), t(tv), float(np.float32(0.05)), diffuse_mask=t(dmask),
        noise={k: t(v) for k, v in noise.items()})
    np.testing.assert_allclose(n(pr), np.asarray(jr), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(ps), np.asarray(js))
    qt = jnp.asarray(rigids[..., :4])
    q0 = jnp.asarray(np.roll(rigids[..., :4], 1, axis=1))
    np.testing.assert_allclose(
        n(pdiff.calc_quat_score(t(qt), t(q0), t(tv))),
        np.asarray(jdiff.calc_quat_score(qt, q0, jnp.asarray(tv))),
        rtol=1e-4, atol=1e-4)
    for pv, jv in zip(pdiff.score_scaling(t(tv)),
                      jdiff.score_scaling(jnp.asarray(tv))):
        np.testing.assert_allclose(n(pv), np.asarray(jv), rtol=1e-5)


# --- trunk ----------------------------------------------------------------------

def _block_inputs(cfg, seed):
    es = cfg.model.embeddings_and_seqformer
    rng = np.random.default_rng(seed)
    b, l = 2, L_AB + L_AG
    seq = rng.standard_normal((b, l, es.seq_channel + es.index_embed_size))
    pair = rng.standard_normal((b, l, l, es.pair_channel
                                + 2 * es.index_embed_size))
    mask = np.ones((b, l), np.float32)
    mask[1, -2:] = 0.0
    return seq.astype(np.float32), pair.astype(np.float32), mask


@pytest.fixture(scope='module')
def block(setup):
    cfg, _, pcfg, _, _ = setup
    seq, pair, mask = _block_inputs(cfg, 7)
    jm = JaxBlock(cfg.model.embeddings_and_seqformer.seqformer)
    tree = _dense(jm, 8, jnp.asarray(seq), jnp.asarray(pair),
                  jnp.asarray(mask))
    want = jm.apply(_jtree(tree), jnp.asarray(seq), jnp.asarray(pair),
                    jnp.asarray(mask))
    pm = SeqformerIteration(pcfg.model.embeddings_and_seqformer.seqformer,
                            seq.shape[-1], pair.shape[-1]).eval()
    params_lib.load_flax_params(pm, tree)
    return pm, (t(seq), t(pair), t(mask)), [np.asarray(w) for w in want]


def test_seqformer_block_matches_jax(block):
    pm, args, want = block
    with torch.no_grad():
        got = pm(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), w, **ACT)


def test_seqformer_block_kernel_route_matches_plain(block, monkeypatch):
    pm, args, want = block
    _force_kernel_route(monkeypatch)
    with torch.no_grad():
        got = pm(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), w, **ACT)


# --- structure module, heads ------------------------------------------------------

@pytest.fixture(scope='module')
def ipa(setup):
    cfg, jdiff, pcfg, pdiff, batch = setup
    seq, pair, _ = _block_inputs(cfg, 9)
    reps = {'seq': jnp.asarray(seq), 'pair': jnp.asarray(pair)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxIpaScore(cfg.model.heads.diffusion_module, diffuser=jdiff)
    tree = _dense(jm, 10, reps, jb)
    want = jm.apply(_jtree(tree), reps, jb)
    pm = IpaScore(pcfg.model.heads.diffusion_module, pdiff, seq.shape[-1],
                  pair.shape[-1]).eval()
    params_lib.load_flax_params(pm, tree)
    pb = {k: t(v) for k, v in batch.items()}
    return pm, {'seq': t(seq), 'pair': t(pair)}, pb, want


@pytest.mark.parametrize('route', ['plain', 'kernel'])
def test_ipa_score_matches_jax(ipa, route, monkeypatch):
    """The kernel route masks keys only: compare on valid query rows."""
    pm, reps, pb, want = ipa
    if route == 'kernel':
        _force_kernel_route(monkeypatch)
    with torch.no_grad():
        got = pm(reps, pb)
    valid = n(pb['mask']) > 0
    for key, tol in (('rot_score', ACT), ('trans_score', ACT),
                     ('structure_act', ACT), ('angles_sin_cos', ACT),
                     ('rigids', COORD)):
        np.testing.assert_allclose(n(got[key])[valid],
                                   np.asarray(want[key])[valid], **tol,
                                   err_msg=key)


def test_heads_match_jax(setup):
    cfg, jdiff, pcfg, pdiff, batch = setup
    rng = np.random.default_rng(11)
    act = rng.standard_normal((2, L_AB + L_AG, 32)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for jcls, pcls, key in ((jax_heads.SequenceHead, port_heads.SequenceHead,
                             'sequence_module'),
                            (jax_heads.PredictedLDDTHead,
                             port_heads.PredictedLDDTHead, 'predicted_lddt')):
        jm = jcls(cfg.model.heads[key])
        args = (jnp.asarray(act), jb) if key == 'sequence_module' \
            else (jnp.asarray(act),)
        tree = _dense(jm, 12, *args)
        want = jm.apply(_jtree(tree), *args)
        pm = pcls(pcfg.model.heads[key], 32)
        params_lib.load_flax_params(pm, tree)
        pargs = (t(act), {k: t(v) for k, v in batch.items()}) \
            if key == 'sequence_module' else (t(act),)
        with torch.no_grad():
            got = pm(*pargs)
        for k in want:
            np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                       **ACT, err_msg=k)
    angles = rng.standard_normal((2, L_AB + L_AG, 7, 2)).astype(np.float32)
    angles /= np.linalg.norm(angles, axis=-1, keepdims=True)
    want = jax_heads.rebuild_atoms(jnp.asarray(batch['seq']),
                                   jnp.asarray(batch['rigids_t']),
                                   jnp.asarray(angles), jb)
    got = port_heads.rebuild_atoms(t(batch['seq']), t(batch['rigids_t']),
                                   t(angles))
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), **COORD,
                                   err_msg=k)


# --- the whole network with recycling ---------------------------------------------

@pytest.fixture(scope='module')
def network(setup):
    """The JAX network's forward with recycling (eager) and the port's
    network with the same weights and inputs."""
    cfg, jdiff, pcfg, pdiff, batch = setup
    jm = JaxScoreNetwork(cfg.model, diffuser=jdiff, antibody_len=L_AB)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = _dense(jm, 13, jb, compute_loss=True)
    want = jm.apply(_jtree(tree), jb, num_recycle=cfg.model.num_recycle)
    pm = ScoreNetworkIteration(pcfg.model, pdiff, L_AB).eval()
    params_lib.load_flax_params(pm, tree)
    pb = {k: t(v) for k, v in batch.items()}
    pb.update(zero_prev(2, L_AB + L_AG, pcfg.model))
    return pcfg, pm, pb, want


def _assert_network_matches(network):
    pcfg, pm, pb, want = network
    assert pcfg.model.num_recycle == 1
    got = forward_with_recycling(pm, pb, pcfg.model.num_recycle,
                                 pcfg.model.embeddings_and_seqformer.prev_pos)
    np.testing.assert_array_equal(n(got['recycled_seq_t']),
                                  np.asarray(want['recycled_seq_t']))
    fold, jfold = got['heads']['folding'], want['heads']['folding']
    for key in ('rot_score', 'trans_score'):
        np.testing.assert_allclose(n(fold[key]), np.asarray(jfold[key]),
                                   **ACT, err_msg=key)
    np.testing.assert_allclose(n(fold['final_atom14_positions']),
                               np.asarray(jfold['final_atom14_positions']),
                               **COORD)
    np.testing.assert_allclose(
        n(got['heads']['sequence_module']['logits']),
        np.asarray(want['heads']['sequence_module']['logits']), **ACT)
    for key in ('seq', 'pair'):
        np.testing.assert_allclose(n(got['representations'][key]),
                                   np.asarray(want['representations'][key]),
                                   **ACT, err_msg=key)


def test_forward_with_recycling_matches_jax(network):
    _assert_network_matches(network)


# The opt-in kernel configuration: the JAX package's opt-in kernel flags,
# with the triangle-attention LN-fold off.
OPT_IN = {'ABX_FUSED_IPA_ATTN': '0', 'ABX_IPA_ATTEND': '1',
          'ABX_PALLAS_TRIANGLE': '1', 'ABX_TRIMULT_GATEFOLD': '1',
          'ABX_TRI_ATTN_LN_FOLD': '0', 'ABX_GATE_PROJ_KERNEL': '1'}


def test_opt_in_forward_with_recycling_matches_jax(network, monkeypatch):
    """The whole network under the opt-in kernel configuration, on the
    forced kernel routes (tests/test_torch_optin.py checks which), against
    the JAX network: the JAX side runs with the flags unset, since off the
    TPU its modules take their plain path whatever the flags say."""
    _force_kernel_route(monkeypatch)
    for k, v in OPT_IN.items():
        monkeypatch.setenv(k, v)
    _assert_network_matches(network)


def test_c_major_forward_with_recycling_matches_jax(network, monkeypatch):
    """The whole network on the forced kernel routes under
    ABX_TRIMULT_C_MAJOR=1, with the opt-in flags but the contraction
    kernel off (so both triangle multiplications take the channel-major
    route, ahead of the gate-fold), against the JAX network as above.
    (With the default flags the forced routes differ from the JAX network
    only at the padded residue, whose outputs carry no meaning, and the
    comparison here covers every residue.)"""
    _force_kernel_route(monkeypatch)
    for k, v in {**OPT_IN, 'ABX_PALLAS_TRIANGLE': '0',
                 'ABX_TRIMULT_C_MAJOR': '1'}.items():
        monkeypatch.setenv(k, v)
    _assert_network_matches(network)


def test_trunk_with_recycled_inputs_kernel_route_matches_plain(setup,
                                                               monkeypatch):
    """Embedding + trunk with non-zero recycled inputs (prev_seq, prev_pair,
    prev_pos bins): the kernel routes, the recycled pair-input assembly
    included, equal the plain path."""
    _, _, pcfg, pdiff, batch = setup
    pm = ScoreNetworkIteration(pcfg.model, pdiff, L_AB).eval()
    params_lib.load_flax_params(pm, params_lib.dense_random_tree(
        params_lib.state_dict_tree(pm), seed=14, scale=0.5))
    pb = {k: t(v) for k, v in batch.items()}
    b, l = pb['seq'].shape
    rng = np.random.default_rng(15)
    prev = zero_prev(b, l, pcfg.model)
    num_bins = pcfg.model.embeddings_and_seqformer.prev_pos.num_bins
    pb.update(prev_seq=t(rng.standard_normal(prev['prev_seq'].shape)),
              prev_pair=t(rng.standard_normal(prev['prev_pair'].shape)),
              prev_pos=t(rng.integers(0, num_bins, (b, l, l))))
    with torch.no_grad():
        want = pm.seqformer(pb)
        _force_kernel_route(monkeypatch)
        got = pm.seqformer(pb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **ACT)
