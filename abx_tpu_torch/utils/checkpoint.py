"""Checkpoint files of the port's trainer: `torch.save`, written atomically.

Counterpart of abx_tpu/utils/checkpoint.py, whose flax msgpack bytes the
port reads through `utils/params.read_msgpack`; what the port writes is a
`torch.save` archive (a zip file), which `is_torch_checkpoint` tells apart.
Orbax is the JAX package's and has no counterpart here.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any

import torch


def save_params(path: str, obj: Any) -> None:
    """Atomic write: `torch.save` to a sibling `.tmp`, flushed and synced,
    then renamed over `path`, so a process killed mid-write leaves the old
    complete file or the new one, never a truncated one."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    obj = _to_cpu(obj)
    with open(tmp, 'wb') as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def load_params(path: str, map_location='cpu'):
    """Read what `save_params` wrote; a damaged or truncated file is
    reported as an error that names it."""
    try:
        return torch.load(path, map_location=map_location, weights_only=True)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 - any unpickling failure
        raise RuntimeError(f'{path}: unreadable checkpoint ({e})') from e


def is_torch_checkpoint(path: str) -> bool:
    """A file `torch.save` wrote (a zip archive), as opposed to a flax
    msgpack checkpoint of the JAX package."""
    return zipfile.is_zipfile(path)
