"""Reference PyTorch checkpoints -> the port's trunk weights.

The port's own copy of the score-network map of
`abx_tpu/utils/torch_convert.py`.  A released AbX checkpoint
(`abx_diffab.ckpt`, `abx_rabd.ckpt`: a `torch.save` of
`{'model_state_dict': ...}` whose keys are the reference `ScoreNetwork`'s,
`impl.seqformer.*`, `impl.diffusion_module.ScoreNetwork.*`, ...) is mapped
onto the flax-shaped tree of the JAX package's names, and
`utils/params.py::flax_to_state_dict` turns that tree into the port's
names: that bridge stays the one place where flax names meet the port's.

Conventions (as in the JAX package's converter):
  * torch nn.Linear weights are (out, in) -> transposed to flax (in, out)
    (and back by the bridge: the port keeps nn.Linear's layout);
  * nn.Embedding tables keep their layout;
  * LayerNorm weight/bias -> scale/bias;
  * SpatialDepthWiseInception's Conv1d(D, D, k, groups=D) weight (D, 1, k)
    -> (k, D).

`convert_reference_ckpt` holds the result to the model strictly: every
entry of the file is read (bar the weightless buffers that
`_REFERENCE_NONPARAM_LEAVES` names), every parameter of the model is
filled and every shape agrees, or an error lists what does not.

`reference_state_dict` is the inverse map, from a port model to the
reference's names.  It exists so that tests and the on-card check can write
a reference-format checkpoint without the reference; it is no feature of
the runtime.
"""

from __future__ import annotations

import logging
import pickle
import pickletools
import re
import zipfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from abx_tpu_torch.utils import checkpoint as ckpt_lib
from abx_tpu_torch.utils import params as params_lib

logger = logging.getLogger(__name__)


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _ln(dst: Dict, prefix_torch: str, sd: Dict):
    return {'scale': np.asarray(sd[f'{prefix_torch}.weight']),
            'bias': np.asarray(sd[f'{prefix_torch}.bias'])}


def _linear(sd: Dict, name: str, bias=True):
    out = {'kernel': _t(sd[f'{name}.weight'])}
    if f'{name}.bias' in sd:
        out['bias'] = np.asarray(sd[f'{name}.bias'])
    return out


def _embed(sd: Dict, name: str):
    return {'embedding': np.asarray(sd[f'{name}.weight'])}


def _mlp(sd: Dict, name: str, torch_idx) -> Dict:
    """Sequential of Linears at given torch indices -> MLP Linear_i tree."""
    return {f'Linear_{i}': _linear(sd, f'{name}.{j}')
            for i, j in enumerate(torch_idx)}


def _sdwi(sd: Dict, name: str) -> Dict:
    """SpatialDepthWiseInception: torch `convs.{i}.conv` is
    Conv1d(D, D, k, groups=D) with weight (D, 1, k) -> flax
    `conv{i}_weight` (k, D) + `conv{i}_bias` (D,)."""
    out = {}
    i = 0
    while f'{name}.convs.{i}.conv.weight' in sd:
        w = np.asarray(sd[f'{name}.convs.{i}.conv.weight'])
        out[f'conv{i}_weight'] = np.ascontiguousarray(w[:, 0, :].T)
        out[f'conv{i}_bias'] = np.asarray(sd[f'{name}.convs.{i}.conv.bias'])
        i += 1
    return out


def _attention(sd: Dict, name: str, fused: bool) -> Dict:
    out = {}
    if fused:
        out['proj_in'] = _linear(sd, f'{name}.proj_in')
    else:
        out['proj_q'] = _linear(sd, f'{name}.proj_q')
        out['proj_k'] = _linear(sd, f'{name}.proj_k')
        out['proj_v'] = _linear(sd, f'{name}.proj_v')
    if f'{name}.gate.weight' in sd:
        out['gate'] = _linear(sd, f'{name}.gate')
    out['proj_out'] = _linear(sd, f'{name}.proj_out')
    for inp in ('inp_q', 'inp_k', 'inp_v'):
        if f'{name}.{inp}.convs.0.conv.weight' in sd:
            out[inp] = _sdwi(sd, f'{name}.{inp}')
    return out


def _transition(sd: Dict, name: str) -> Dict:
    return {
        'norm': _ln(None, f'{name}.transition.0', sd),
        'in_proj': _linear(sd, f'{name}.transition.1'),
        'out_proj': _linear(sd, f'{name}.transition.3'),
    }


def _tri_mul(sd: Dict, name: str) -> Dict:
    out = {
        'norm': _ln(None, f'{name}.norm', sd),
        'left_proj': _linear(sd, f'{name}.left_proj'),
        'right_proj': _linear(sd, f'{name}.right_proj'),
        'final_norm': _ln(None, f'{name}.final_norm', sd),
        'proj_out': _linear(sd, f'{name}.proj_out'),
    }
    if f'{name}.left_gate.weight' in sd:
        out['left_gate'] = _linear(sd, f'{name}.left_gate')
        out['right_gate'] = _linear(sd, f'{name}.right_gate')
        out['final_gate'] = _linear(sd, f'{name}.final_gate')
    for inp in ('inp_left', 'inp_right'):
        if f'{name}.{inp}.convs.0.conv.weight' in sd:
            out[inp] = _sdwi(sd, f'{name}.{inp}')
    return out


def _tri_attn(sd: Dict, name: str) -> Dict:
    return {
        'norm': _ln(None, f'{name}.norm', sd),
        'proj_pair': _linear(sd, f'{name}.proj_pair'),
        'attn': _attention(sd, f'{name}.attn', fused=False),
    }


def convert_score_network(sd: Dict, esm_enabled: bool = False,
                          num_blocks: int = 1,
                          num_transition: int = 3,
                          num_torsion_blocks: int = 2) -> Dict:
    """Reference ScoreNetwork state_dict -> flax {'params': ...} tree."""
    p: Dict[str, Any] = {}

    # -- EmbeddingAndSeqformer (ours: impl/seqformer) ----------------------
    es: Dict[str, Any] = {}
    base = 'impl.seqformer'
    es['proj_aa_type'] = _embed(sd, f'{base}.proj_aa_type')
    es['proj_rel_pos'] = _embed(sd, f'{base}.proj_rel_pos')
    es['aa_proj_norm'] = _ln(None, f'{base}.aa_proj.0', sd)
    es['aa_proj'] = _mlp(sd, f'{base}.aa_proj', (1, 3))
    if esm_enabled:
        p['esm_embed_weights'] = np.asarray(sd[f'{base}.esm_embed_weights'])
        es['esm_norm'] = _ln(None, f'{base}.proj_esm_embed.0', sd)
        es['proj_esm_embed'] = _mlp(sd, f'{base}.proj_esm_embed', (1, 3))
    es['prev_seq_norm'] = _ln(None, f'{base}.prev_seq_norm', sd)
    es['prev_pair_norm'] = _ln(None, f'{base}.prev_pair_norm', sd)
    es['proj_prev_pos'] = _embed(sd, f'{base}.proj_prev_pos')

    # Residue encoder.
    re_base = f'{base}.encode_residue_emb'
    es['encode_residue_emb'] = {
        'aatype_embed': _embed(sd, f'{re_base}.aatype_embed'),
        'cdr_embed': _embed(sd, f'{re_base}.cdr_embed'),
        'coordinate_embed': _mlp(sd, f'{re_base}.coordinate_embed', (0, 2)),
        'mlp': _mlp(sd, f'{re_base}.mlp', (0, 2, 4, 6)),
    }
    # Pair encoder.
    pe_base = f'{base}.encode_pair_emb'
    es['encode_pair_emb'] = {
        'aa_pair_embed': _embed(sd, f'{pe_base}.aa_pair_embed'),
        'relpos_embed': _embed(sd, f'{pe_base}.relpos_embed'),
        'aapair_to_distcoef': np.asarray(
            sd[f'{pe_base}.aapair_to_distcoef.weight']),
        'distance_embed': _mlp(sd, f'{pe_base}.distance_embed', (0, 2)),
        'dgram_embed': _embed(sd, f'{pe_base}.dgram_embed'),
        'out_mlp': _mlp(sd, f'{pe_base}.out_mlp', (0, 2, 4)),
    }

    # Trunk blocks.
    sf = {}
    for b in range(num_blocks):
        blk = f'{base}.seqformer.blocks.{b}'
        sf[f'block_{b}'] = {
            'seq_attn': {
                'seq_norm': _ln(None, f'{blk}.seq_attn.seq_norm', sd),
                'pair_norm': _ln(None, f'{blk}.seq_attn.pair_norm', sd),
                'proj_pair': _linear(sd, f'{blk}.seq_attn.proj_pair'),
                'attn': _attention(sd, f'{blk}.seq_attn.attn', fused=True),
            },
            'seq_transition': _transition(sd, f'{blk}.seq_transition'),
            'outer_product_mean': {
                'norm': _ln(None, f'{blk}.outer_product_mean.norm', sd),
                'left_proj': _linear(
                    sd, f'{blk}.outer_product_mean.left_proj'),
                'right_proj': _linear(
                    sd, f'{blk}.outer_product_mean.right_proj'),
                'out_proj': _linear(
                    sd, f'{blk}.outer_product_mean.out_proj'),
            },
            'tri_mul_out': _tri_mul(
                sd, f'{blk}.triangle_multiplication_outgoing'),
            'tri_mul_in': _tri_mul(
                sd, f'{blk}.triangle_multiplication_incoming'),
            'tri_attn_start': _tri_attn(
                sd, f'{blk}.triangle_attention_starting_node'),
            'tri_attn_end': _tri_attn(
                sd, f'{blk}.triangle_attention_ending_node'),
            'pair_transition': _transition(sd, f'{blk}.pair_transition'),
        }
    es['seqformer'] = sf

    # -- IpaScore (ours: impl/diffusion_module) ----------------------------
    ip_base = 'impl.diffusion_module.ScoreNetwork'
    ipa = {
        'proj_q_scalar': _linear(sd, f'{ip_base}.attention_module.'
                                     f'proj_q_scalar'),
        'proj_kv_scalar': _linear(sd, f'{ip_base}.attention_module.'
                                      f'proj_kv_scalar'),
        'proj_q_point_local': _linear(sd, f'{ip_base}.attention_module.'
                                          f'proj_q_point_local'),
        'proj_kv_point_local': _linear(sd, f'{ip_base}.attention_module.'
                                           f'proj_kv_point_local'),
        'proj_pair': _linear(sd, f'{ip_base}.attention_module.proj_pair'),
        'trainable_point_weights': np.asarray(
            sd[f'{ip_base}.attention_module.trainable_point_weights']),
        'final_proj': _linear(sd, f'{ip_base}.attention_module.final_proj'),
    }
    dm: Dict[str, Any] = {
        'proj_init_seq_act': _linear(sd, f'{ip_base}.proj_init_seq_act'),
        'proj_init_pair_act': _linear(sd, f'{ip_base}.proj_init_pair_act'),
        'init_seq_norm': _ln(None, f'{ip_base}.init_seq_layer_norm', sd),
        'init_pair_norm': _ln(None, f'{ip_base}.init_pair_layer_norm', sd),
        'proj_seq': _linear(sd, f'{ip_base}.proj_seq'),
        'ipa': ipa,
        'attention_norm': _ln(None, f'{ip_base}.attention_layer_norm', sd),
        'transition_norm': _ln(None, f'{ip_base}.transition_layer_norm', sd),
        'affine_update': _linear(sd, f'{ip_base}.affine_update'),
    }
    for k in range(num_transition):
        dm[f'transition_{k}'] = _linear(
            sd, f'{ip_base}.transition_module.{2 * k}')
    tm_base = f'{ip_base}.sidechain_module.torsion_module'
    torsion = {
        'proj_act': _linear(sd, f'{tm_base}.proj_act.1'),
        'proj_init_act': _linear(sd, f'{tm_base}.proj_init_act.1'),
        'projection': _linear(sd, f'{tm_base}.projection'),
    }
    for k in range(num_torsion_blocks):
        torsion[f'block_{k}_linear1'] = _linear(
            sd, f'{tm_base}.blocks.{k}.net.1')
        torsion[f'block_{k}_linear2'] = _linear(
            sd, f'{tm_base}.blocks.{k}.net.3')
    dm['torsion_module'] = torsion

    # -- heads -------------------------------------------------------------
    def head_mlp(name):
        return {
            'norm': _ln(None, f'impl.{name}.net.0', sd),
            'linear1': _linear(sd, f'impl.{name}.net.1'),
            'linear2': _linear(sd, f'impl.{name}.net.3'),
            'linear3': _linear(sd, f'impl.{name}.net.5'),
        }

    impl = {
        'seqformer': es,
        'diffusion_module': dm,
        'sequence_module': head_mlp('sequence_module'),
        'predicted_lddt': head_mlp('predicted_lddt'),
    }
    if 'impl.distogram.proj.weight' in sd:
        impl['distogram'] = {'proj': _linear(sd, 'impl.distogram.proj')}
    if esm_enabled:
        impl['seqformer']['esm_embed_weights'] = p.pop('esm_embed_weights')
    return {'params': {'impl': impl}}


# -- reading a file, and the strict check against the model ----------------

class _TrackedDict(dict):
    """The reference state dict, recording which entries the map read and
    which it asked for in vain (an empty (0, 1, 0) array stands in for a
    missing entry, so that the map runs on and every missing name is
    listed)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.consumed = set()
        self.missing = []

    def __getitem__(self, k):
        if k not in self:
            self.missing.append(k)
            return np.zeros((0, 1, 0), np.float32)
        self.consumed.add(k)
        return super().__getitem__(k)


def _names_reference_entries(path: str) -> bool:
    """Whether the pickle of the `torch.save` archive at `path` names a
    reference checkpoint's entries (`model_state_dict`, or a key starting
    `impl.`).  The opcodes are only listed (`pickletools`), never run."""
    try:
        with zipfile.ZipFile(path) as zf:
            pkl = next(n for n in zf.namelist()
                       if n.rsplit('/', 1)[-1] == 'data.pkl')
            data = zf.read(pkl)
        return any(isinstance(arg, str) and (arg == 'model_state_dict'
                                             or arg.startswith('impl.'))
                   for _, arg, _ in pickletools.genops(data))
    except (OSError, StopIteration, ValueError, zipfile.BadZipFile):
        return False


def read_checkpoint(path: str):
    """A `torch.save` archive of trunk weights, read onto the CPU by
    `utils/checkpoint.py::load_params` (tensors and plain containers only;
    an unreadable file raises an error naming it).  Only a reference
    checkpoint that holds more than that (a training checkpoint with its
    config objects, as a released `.ckpt` may be) is read again by the
    full unpickler, with a warning naming the file: that unpickler runs
    code from the file, so such a file must be trusted."""
    try:
        return ckpt_lib.load_params(path)
    except RuntimeError as e:
        if not (isinstance(e.__cause__, pickle.UnpicklingError)
                and _names_reference_entries(path)):
            raise
    logger.warning('%s: a reference checkpoint with entries other than '
                   'tensors; reading it with the full unpickler, which runs '
                   'code from the file', path)
    return torch.load(path, map_location='cpu', weights_only=False)


def is_reference_state_dict(obj) -> bool:
    """A reference checkpoint: a mapping with `model_state_dict`, or one
    whose keys are the reference ScoreNetwork's (`impl.`)."""
    return isinstance(obj, Mapping) and (
        'model_state_dict' in obj
        or any(isinstance(k, str) and k.startswith('impl.') for k in obj))


def _as_numpy(v):
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:   # numpy has no bfloat16; f32 holds it
        v = v.float()
    return v.numpy()


# Entries a reference checkpoint may hold beside its parameters: buffers
# that carry no weight (those the JAX package's ESM2 converter tolerates,
# and a BatchNorm's step count), matched on the last part of the name.
# No released file is in the repository to tell which it holds; any other
# entry that the map does not read is refused by name.
_REFERENCE_NONPARAM_LEAVES = ('inv_freq', '_float_tensor', 'position_ids',
                              'num_batches_tracked')


def convert_reference_state_dict(state, cfg) -> Dict[str, torch.Tensor]:
    """A reference ScoreNetwork state dict (or a checkpoint dict holding it
    under `model_state_dict`) -> the port's state dict (f32), by the map
    above and `flax_to_state_dict`.  Raises, naming the entries, when the
    map needs an entry the file lacks or leaves one of the file's unread
    that `_REFERENCE_NONPARAM_LEAVES` does not name."""
    sd = state.get('model_state_dict', state)
    sd = _TrackedDict({k: _as_numpy(v) for k, v in sd.items()})
    es = cfg.model.embeddings_and_seqformer
    ipa = cfg.model.heads.diffusion_module.IPA
    tree = convert_score_network(
        sd, esm_enabled=bool(es.esm.enabled),
        num_blocks=es.seqformer_num_block,
        num_transition=ipa.num_layer_in_transition,
        num_torsion_blocks=ipa.torsion.num_residual_block)
    unread = sorted(k for k in sd if k not in sd.consumed)
    buffers = [k for k in unread
               if k.rsplit('.', 1)[-1] in _REFERENCE_NONPARAM_LEAVES]
    unread = [k for k in unread if k not in buffers]
    if sd.missing or unread:
        raise ValueError(
            'reference checkpoint does not fit the configured model:\n'
            f' missing={sorted(set(sd.missing))[:10]}\n'
            f' unexpected={unread[:10]}')
    if buffers:
        logger.info('reference checkpoint: %d weightless buffers not read '
                    '(%s)', len(buffers), buffers[:5])
    return params_lib.flax_to_state_dict(tree)


def load_reference_state_dict(model: torch.nn.Module, state, cfg
                              ) -> Dict[str, torch.Tensor]:
    """Convert a reference state dict and load it into `model` strictly:
    one error lists the model's entries it lacks, the entries the model
    does not have and the shapes that differ.  Each weight is copied into
    the model's parameter, so it takes that parameter's dtype and device,
    and the packed-weight caches, which watch their sources' versions,
    rebuild on the next call.  Returns the converted state dict."""
    converted = convert_reference_state_dict(state, cfg)
    model.load_state_dict(converted, strict=True)
    return converted


def convert_reference_ckpt(path: str, model: torch.nn.Module, cfg
                           ) -> Dict[str, torch.Tensor]:
    """Load a reference `.ckpt` (the `torch.save` of a dict with the state
    dict under `model_state_dict`, or the state dict itself) into `model`
    (see `read_checkpoint` on what is read how)."""
    return load_reference_state_dict(model, read_checkpoint(path), cfg)


# -- the inverse map: the port's names -> the reference's -------------------

_BLOCK_PARTS = {
    'tri_mul_out': 'triangle_multiplication_outgoing',
    'tri_mul_in': 'triangle_multiplication_incoming',
    'tri_attn_start': 'triangle_attention_starting_node',
    'tri_attn_end': 'triangle_attention_ending_node',
}
_DM_PARTS = {
    'init_seq_norm': 'init_seq_layer_norm',
    'init_pair_norm': 'init_pair_layer_norm',
    'attention_norm': 'attention_layer_norm',
    'transition_norm': 'transition_layer_norm',
    'ipa': 'attention_module',
}
# (pattern over the port's name without its leaf, replacement), in order;
# the first that matches applies.
_RENAMES: Tuple[Tuple[str, str], ...] = (
    (r'seqformer\.aa_proj_norm', 'seqformer.aa_proj.0'),
    (r'seqformer\.aa_proj\.Linear_(\d)',
     lambda m: f'seqformer.aa_proj.{2 * int(m[1]) + 1}'),
    (r'seqformer\.esm_norm', 'seqformer.proj_esm_embed.0'),
    (r'seqformer\.proj_esm_embed\.Linear_(\d)',
     lambda m: f'seqformer.proj_esm_embed.{2 * int(m[1]) + 1}'),
    (r'(seqformer\.encode_(?:residue|pair)_emb\.\w+)\.Linear_(\d)',
     lambda m: f'{m[1]}.{2 * int(m[2])}'),
    (r'seqformer\.seqformer\.block_(\d+)\.(seq|pair)_transition\.norm',
     r'seqformer.seqformer.blocks.\1.\2_transition.transition.0'),
    (r'seqformer\.seqformer\.block_(\d+)\.(seq|pair)_transition\.in_proj',
     r'seqformer.seqformer.blocks.\1.\2_transition.transition.1'),
    (r'seqformer\.seqformer\.block_(\d+)\.(seq|pair)_transition\.out_proj',
     r'seqformer.seqformer.blocks.\1.\2_transition.transition.3'),
    (r'seqformer\.seqformer\.block_(\d+)\.(\w+)(.*)',
     lambda m: (f'seqformer.seqformer.blocks.{m[1]}.'
                f'{_BLOCK_PARTS.get(m[2], m[2])}{m[3]}')),
    (r'diffusion_module\.transition_(\d+)',
     lambda m: f'diffusion_module.ScoreNetwork.transition_module.'
               f'{2 * int(m[1])}'),
    (r'diffusion_module\.torsion_module\.(proj_act|proj_init_act)',
     r'diffusion_module.ScoreNetwork.sidechain_module.torsion_module.\1.1'),
    (r'diffusion_module\.torsion_module\.block_(\d+)_linear(\d)',
     lambda m: (f'diffusion_module.ScoreNetwork.sidechain_module.'
                f'torsion_module.blocks.{m[1]}.net.{2 * int(m[2]) - 1}')),
    (r'diffusion_module\.torsion_module\.(\w+)',
     r'diffusion_module.ScoreNetwork.sidechain_module.torsion_module.\1'),
    (r'diffusion_module\.(\w+)(.*)',
     lambda m: (f'diffusion_module.ScoreNetwork.'
                f'{_DM_PARTS.get(m[1], m[1])}{m[2]}')),
    (r'(sequence_module|predicted_lddt)\.norm', r'\1.net.0'),
    (r'(sequence_module|predicted_lddt)\.linear(\d)',
     lambda m: f'{m[1]}.net.{2 * int(m[2]) - 1}'),
)


def _reference_name(key: str) -> Tuple[str, bool]:
    """The reference's name of one port entry, and whether the entry is an
    SDWI convolution weight (stored (k, D) here, (D, 1, k) there)."""
    parts = key.split('.')
    leaf, path = parts[-1], '.'.join(parts[:-1])
    conv = re.fullmatch(r'conv(\d+)_(weight|bias)', leaf)
    if conv:
        path, leaf = f'{path}.convs.{conv[1]}.conv', conv[2]
    elif leaf in ('scale', 'embedding'):
        leaf = 'weight'
    elif leaf == 'aapair_to_distcoef':      # an nn.Embedding there
        path, leaf = f'{path}.{leaf}', 'weight'
    for pattern, repl in _RENAMES:
        new = re.sub(f'^{pattern}$', repl, path)
        if new != path:
            path = new
            break
    name = f'impl.{path}.{leaf}' if path else f'impl.{leaf}'
    return name, bool(conv) and conv[2] == 'weight'


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port model's weights under the reference ScoreNetwork's names
    and layouts, as a released checkpoint holds them under
    `model_state_dict` (CPU tensors in the parameters' dtype).  For tests
    and the on-card check, which write reference-format files from random
    weights; the runtime reads such files and never writes them."""
    out = {}
    for key, v in model.state_dict().items():
        name, conv = _reference_name(key)
        v = v.detach().cpu().clone()
        if conv:
            v = v.t().contiguous().unsqueeze(1)
        out[name] = v
    return out
