"""Weight bridge: the JAX package's parameter tree -> the port's state_dict.

The port's modules carry the flax names (`params/impl/<path>`), so the map
is by name: drop the leading `params` / `impl` levels, join the path with
dots, and turn each flax `kernel` (in, out) into the nn.Linear `weight`
(out, in) by a transpose.  Every other leaf (LayerNorm `scale` / `bias`,
`embedding` tables, `trainable_point_weights`, `aapair_to_distcoef`, and
SpatialDepthWiseInception's `conv{i}_weight` (k, D) / `conv{i}_bias`
under `inp_q`, `inp_k`, `inp_v`, `inp_left`, `inp_right`, which the port
keeps in the flax layout) keeps its name and layout.  This module is the
only place where layouts change.

Sources: the tree from `abx_tpu.cli.runner._random_init` (as numpy arrays)
or a `.msgpack` written by `abx_tpu/utils/checkpoint.py` (flax msgpack
bytes, read here with the `msgpack` package — no flax or jax needed).

ESM2 weights have their own bridge (`esm_flax_to_state_dict`,
`fair_esm_state_dict`, `load_esm_params`, and `load_lm_head_params` for
the masked-LM head under `lm_head.`): the port's `models/esm.py` carries
fair-esm's names, so a fair-esm state dict loads as it is, and the JAX
package's ESM tree (per-layer `layer_{i}`, or the scanned `layers/layer`
with a leading layer axis, and its `lm_head`) is renamed onto them.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch


def _flatten(tree, path=()) -> Dict[Tuple[str, ...], np.ndarray]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (str(k),)))
        return out
    return {path: np.asarray(tree)}


def flax_to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested mappings of arrays) -> torch state_dict."""
    out = {}
    for path, v in _flatten(tree).items():
        p = list(path)
        if p and p[0] == 'params':
            p = p[1:]
        if p and p[0] == 'impl':
            p = p[1:]
        if p[-1] == 'kernel':
            p[-1] = 'weight'
            v = v.T
        out['.'.join(p)] = torch.tensor(np.asarray(v, dtype=np.float32))
    return out


def load_flax_params(model: torch.nn.Module, tree) -> None:
    """Load a flax tree into `model` (strict: every name must match)."""
    state = flax_to_state_dict(tree)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f'param bridge mismatch: missing={missing[:8]} '
                       f'unexpected={unexpected[:8]}')


def read_msgpack(path: str):
    """Read a flax msgpack checkpoint into nested dicts of numpy arrays
    (flax's ndarray extension type 1: msgpack (shape, dtype, bytes))."""
    import msgpack

    def ext_hook(code, data):
        if code == 1:
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            name = dtype.decode() if isinstance(dtype, bytes) else dtype
            return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
        if code == 3:
            dtype, buf = msgpack.unpackb(data, raw=True)
            name = dtype.decode() if isinstance(dtype, bytes) else dtype
            return np.frombuffer(buf, dtype=np.dtype(name))[0]
        return msgpack.ExtType(code, data)

    with open(path, 'rb') as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False,
                               strict_map_key=False)


def dense_random_tree(tree, seed: int, scale: float = 1.0):
    """A tree of the same shapes with dense random values (numpy, f32).

    AF2 inits zero every 'final' and 'gate' kernel, which would let a
    comparison pass without exercising the layers behind them; parity
    tests and the on-card kernel checks use these weights instead:
    kernels ~ N(0, scale^2 / fan_in), biases and embeddings ~ N(0, 0.1^2)
    (embeddings N(0, 1)), LayerNorm scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name == 'kernel':
            std = scale / np.sqrt(shape[0])
            return (rng.standard_normal(shape) * std).astype(np.float32)
        if name == 'scale':
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == 'embedding':
            return rng.standard_normal(shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return walk(tree, '')


def state_dict_tree(model: torch.nn.Module):
    """The port's parameters as a flax-shaped tree of numpy arrays
    ({'params': {'impl': ...}}, kernels (in, out)) — the inverse map, used
    to build random weights of a model's shape without jax."""
    root: dict = {}
    for key, p in model.state_dict().items():
        parts = key.split('.')
        v = p.detach().cpu().float().numpy()
        if parts[-1] == 'weight' and v.ndim == 2:
            parts[-1] = 'kernel'
            v = v.T
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return {'params': {'impl': root}}


# fair-esm checkpoint entries that are not parameters of the encoder or of
# the masked-LM head: the rotary frequency buffers, the contact head and
# fairseq bookkeeping.
_ESM_DROPPED = ('rot_emb.inv_freq', 'contact_head.', '_float_tensor',
                'embed_positions.')
LM_HEAD = 'lm_head.'
# The LM head's projection: tied to `embed_tokens.weight` in fair-esm, and
# the JAX CLI projects with the embedding table (`abx_tpu/cli/eval_pll.py`),
# so `ESM2LMHead` takes the table from the encoder and this entry is not
# loaded.
_LM_TIED = LM_HEAD + 'weight'


def _esm_entry(path, v):
    """One leaf of the JAX ESM tree -> (fair-esm name, array)."""
    leaf = path[-1]
    if leaf == 'kernel':
        v = v.T
    if leaf in ('kernel', 'scale', 'embedding'):
        path = path[:-1] + ['weight']
    return '.'.join(path), v


def esm_flax_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """The JAX package's ESM2 tree ({'params': ...}, numpy or array leaves)
    -> the port's ESM2 state dict (fair-esm names, numpy arrays).  Takes
    both layouts: per-layer `layer_{i}` and the scanned `layers/layer` with
    a leading layer axis.  The masked-LM head (`lm_head/{dense,
    layer_norm,bias}`, and `weight` where the tree has one) comes along
    under `lm_head.`."""
    out = {}
    for path, v in _flatten(tree).items():
        p = list(path)
        if p[0] == 'params':
            p = p[1:]
        if p[:2] == ['layers', 'layer']:
            for i in range(v.shape[0]):
                k, vi = _esm_entry(['layers', str(i)] + p[2:], v[i])
                out[k] = vi
            continue
        m = re.fullmatch(r'layer_(\d+)', p[0])
        if m:
            p = ['layers', m.group(1)] + p[1:]
        k, v = _esm_entry(p, v)
        out[k] = v
    return out


def fair_esm_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A fair-esm ESM2 `.pt` checkpoint -> the port's ESM2 state dict
    (counterpart of `abx_tpu/utils/torch_convert.py::convert_esm2_ckpt`):
    the `encoder.` prefixes stripped, the rotary buffers and contact head
    dropped; the masked-LM head's entries (`lm_head.dense.*`,
    `lm_head.layer_norm.*`, `lm_head.weight`, `lm_head.bias`) kept."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('model', ckpt)
    out = {}
    for k, v in sd.items():
        k = k.replace('encoder.sentence_encoder.', '').replace('encoder.', '')
        if not any(d in k for d in _ESM_DROPPED):
            out[k] = v
    return out


def has_lm_head(state) -> bool:
    """The ESM2 state dict carries the masked-LM head."""
    return any(k.startswith(LM_HEAD) for k in state)


def _load_strict(module, sd, device, dtype, what):
    sd = {k: (v if torch.is_tensor(v)
              else torch.from_numpy(np.array(v, np.float32))).to(
                  device=device, dtype=dtype)
          for k, v in sd.items()}
    missing, unexpected = module.load_state_dict(sd, strict=False,
                                                 assign=True)
    if missing or unexpected:
        raise KeyError(f'{what} weight mismatch: missing={missing[:8]} '
                       f'unexpected={unexpected[:8]}')


def load_esm_params(module: torch.nn.Module, state, device, dtype) -> None:
    """Load an ESM2 state dict (tensors or numpy arrays) into the encoder
    `module`, in the compute dtype on `device` (frozen weights: bf16 halves
    the 3B model's residency).  The module may live on the 'meta' device:
    the loaded tensors take the place of its parameters.  Strict both ways
    over the encoder's entries; the masked-LM head's (`lm_head.*`) are
    `load_lm_head_params`'."""
    _load_strict(module, {k: v for k, v in state.items()
                          if not k.startswith(LM_HEAD)},
                 device, dtype, 'ESM2')


def load_lm_head_params(head: torch.nn.Module, state, device, dtype
                        ) -> None:
    """Load the `lm_head.*` entries of an ESM2 state dict into an
    `ESM2LMHead`, strict both ways, as `load_esm_params` does; the tied
    projection (`lm_head.weight`) is not loaded (see `_LM_TIED`)."""
    _load_strict(head, {k[len(LM_HEAD):]: v for k, v in state.items()
                        if k.startswith(LM_HEAD) and k != _LM_TIED},
                 device, dtype, 'ESM2 LM head')
