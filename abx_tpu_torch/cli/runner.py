"""Shared CLI runtime on one device: model/diffuser construction and the
design sampling driver (counterpart of abx_tpu/cli/runner.py, without the
mesh).  Complexes are read and written with the JAX package's
framework-free data and output modules.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from abx_tpu.data import dataset as ds
from abx_tpu.data.dataset import DataConfig
from abx_tpu.sampling.output import postprocess_reference, postprocess_sample
from abx_tpu_torch import config as config_lib
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models.modules import reset_parameters
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.ops import _lib
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import params as params_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Runtime:
    config: config_lib.Cfg
    diffuser: JointDiffuser
    model: ScoreNetworkIteration
    data_config: DataConfig
    device: torch.device


def resolve_device(name: str) -> torch.device:
    """'cuda' needs a card and never falls back; 'cpu' only when asked."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu explicitly to run on the CPU)')
    return dev


def build_runtime(model_config_path: Optional[str] = None,
                  checkpoint_path: Optional[str] = None, tiny: bool = False,
                  seed: int = 0, bf16: bool = False,
                  device: str = 'cuda') -> Runtime:
    dev = resolve_device(device)
    if dev.type == 'cuda':
        # Build/load the kernels now: a missing toolkit fails before any
        # complex is read, and sampling times exclude the first-use build.
        _lib.lib()
    if tiny:
        cfg = config_lib.tiny_model_config()
        # tiny channels, but the real-complex shape budget.
        cfg.data.max_antibody_len = 256
        cfg.data.max_antigen_len = 32
    else:
        cfg = config_lib.load_config(model_config_path)
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()),
                             device=dev)
    dcfg = DataConfig(cfg.data.max_antibody_len, cfg.data.max_antigen_len,
                      cfg.data.patch_radius, cfg.data.anchor_neighbors,
                      cfg.data.get('parity_random_antigen_window', False))
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = ScoreNetworkIteration(cfg.model, diffuser,
                                  cfg.data.max_antibody_len, dtype=dtype)
    if checkpoint_path:
        params_lib.load_flax_params(model,
                                    params_lib.read_msgpack(checkpoint_path))
        logger.info('loaded checkpoint %s', checkpoint_path)
    else:
        reset_parameters(model, seed)
        logger.warning('no checkpoint: using randomly initialised weights')
    model.to(dev).eval()
    return Runtime(cfg, diffuser, model, dcfg, dev)


def load_complexes(pdb_file: str, runtime: Runtime):
    """Yield (feats, meta) for a complex PDB named <code>_<H>_<L>_<AG>.pdb."""
    name = os.path.splitext(os.path.basename(pdb_file))[0]
    parts = name.split('_')
    antigens = parts[3].split('|') if len(parts) > 3 else []
    ex = ds.complex_from_pdb(pdb_file, parts[1], parts[2], antigens)
    prep = ds.prepare_example(ex, runtime.data_config, False)
    if prep is not None:
        yield prep


def sample_generator(device: torch.device, seed: int, name: str,
                     sample_idx: int) -> torch.Generator:
    """Per-chunk generator, stable across processes (crc32, not hash())."""
    key = (seed * 1_000_003 + zlib.crc32(name.encode('utf-8'))) * 65_537 \
        + sample_idx
    return torch.Generator(device=device).manual_seed(key % (2**63))


def run_sampling(runtime: Runtime, output_dir: str, complexes,
                 num_samples: int = 1, generate_area: str = 'H3',
                 num_t: Optional[int] = None, seed: int = 42,
                 batch_samples: Optional[int] = None
                 ) -> List[Tuple[str, int, float]]:
    """Design `num_samples` samples of each complex, `batch_samples` at a
    time in the batch axis; writes reference/<name>.pdb and
    <NNNN>/<name>.pdb under `output_dir`.  Returns (name, n, seconds) per
    batch."""
    cfg = runtime.config
    num_t = num_t or cfg.diffuser.inference_step
    batch_samples = batch_samples or 1
    sampler = Sampler(runtime.model, runtime.diffuser, cfg.model,
                      SamplerConfig(num_t=num_t, generate_area=generate_area))
    ref_dir = os.path.join(output_dir, 'reference')
    os.makedirs(ref_dir, exist_ok=True)
    results_log = []
    for feats, meta in complexes:
        name = meta['name']
        batch = ds.stack_batch([feats])
        postprocess_reference(ref_dir, meta, batch)
        sample_idx = 0
        while sample_idx < num_samples:
            n = min(batch_samples, num_samples - sample_idx)
            tiled = {k: np.repeat(v, n, axis=0) for k, v in batch.items()}
            gen = sample_generator(runtime.device, seed, name, sample_idx)
            t0 = time.time()
            try:
                result = sampler.sample(
                    to_device_batch(tiled, runtime.device), gen)
                result = {k: v.float().cpu().numpy()
                          if v.is_floating_point() else v.cpu().numpy()
                          for k, v in result.items()}
            except Exception:
                # Per-complex resilience, as the JAX runner: log and go on.
                logger.exception('sampling failed for %s; skipping', name)
                break
            elapsed = time.time() - t0
            logger.info('%s: %d samples in %.2fs (%.2f samples/s)', name, n,
                        elapsed, n / elapsed)
            results_log.append((name, n, elapsed))
            for i in range(n):
                sdir = os.path.join(output_dir, f'{sample_idx + i:04d}')
                os.makedirs(sdir, exist_ok=True)
                postprocess_sample(sdir, meta, result, i)
            sample_idx += n
    return results_log
