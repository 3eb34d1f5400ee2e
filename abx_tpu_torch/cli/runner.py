"""Shared CLI runtime: model/diffuser construction, complex loading (one
PDB, or a name index over a directory of npz files) and the sampling loop
of the design, optimize and trajectory modes (counterpart of
abx_tpu/cli/runner.py).

One process runs on one device.  Complexes are spread over hosts by the
caller (`data/dataset.py::shard_names`, cli/inference.py); within a host,
the ranks of a `mesh` (parallel/mesh.py) share each chunk's samples, as the
JAX runner shards a chunk over a host's local devices.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from abx_tpu_torch import config as config_lib
from abx_tpu_torch.data import dataset as ds
from abx_tpu_torch.data.dataset import DataConfig
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models.esm import AntibodyESM, ESM2Config, esm2_num_heads
from abx_tpu_torch.models.modules import reset_parameters
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.ops import _lib
from abx_tpu_torch.parallel import mesh as mesh_lib
from abx_tpu_torch.sampling.output import (postprocess_reference,
                                           postprocess_sample,
                                           postprocess_trajectory)
from abx_tpu_torch.sampling.picard import draw_noise
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import checkpoint as ckpt_lib
from abx_tpu_torch.utils import params as params_lib
from abx_tpu_torch.utils import torch_convert

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Runtime:
    config: config_lib.Cfg
    diffuser: JointDiffuser
    model: ScoreNetworkIteration
    data_config: DataConfig
    device: torch.device
    # The ESM2 conditioning module (frozen, in the compute dtype) when
    # esm.enabled, else None.
    esm: Optional[AntibodyESM] = None


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
                  device: str = 'cuda',
                  esm_checkpoint: Optional[str] = None,
                  esm_random: bool = False,
                  esm_layers: Optional[int] = None,
                  esm_dim: Optional[int] = None) -> Runtime:
    """`checkpoint_path`: the trunk's weights, a reference checkpoint (the
    released AbX `.ckpt`), a weights file of the port's trainer
    (`train/trainer.py`) or a flax msgpack of the JAX package, told apart
    by `load_trunk_weights`.
    `esm_checkpoint` (a msgpack of the JAX package's ESM2 tree, or a
    fair-esm `.pt`) or `esm_random` (a full-shape ESM2 with random weights,
    for speed and memory studies) turns ESM conditioning on; `esm_layers`
    and `esm_dim` override the ESM2 shape."""
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
    if esm_checkpoint or esm_random:
        # Before the model is built, so the trunk's ESM projection exists.
        es = cfg.model.embeddings_and_seqformer.esm
        es.enabled = True
        if esm_layers:
            es.num_layers = esm_layers
        if esm_dim:
            es.embed_channel = esm_dim
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()),
                             device=dev)
    dcfg = DataConfig(cfg.data.max_antibody_len, cfg.data.max_antigen_len,
                      cfg.data.patch_radius, cfg.data.anchor_neighbors,
                      cfg.data.get('parity_random_antigen_window', False))
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = ScoreNetworkIteration(cfg.model, diffuser,
                                  cfg.data.max_antibody_len, dtype=dtype)
    if checkpoint_path:
        kind = load_trunk_weights(model, checkpoint_path, cfg)
        logger.info('loaded checkpoint %s (%s)', checkpoint_path, kind)
    else:
        reset_parameters(model, seed)
        logger.warning('no checkpoint: using randomly initialised weights')
    model.to(dev).eval()
    esm = None
    if esm_checkpoint:
        esm = _esm_module(cfg, dtype)
        state = (params_lib.fair_esm_state_dict(esm_checkpoint)
                 if esm_checkpoint.endswith(('.pt', '.pth', '.ckpt'))
                 else params_lib.esm_flax_to_state_dict(
                     params_lib.read_msgpack(esm_checkpoint)))
        params_lib.load_esm_params(esm.module, state, dev, dtype)
        logger.info('loaded ESM2 weights %s', esm_checkpoint)
    elif esm_random:
        esm = _random_esm(cfg, dtype, dev, seed)
        logger.warning('esm_random: ESM2 with randomly initialised weights '
                       '(speed and memory studies only)')
    if esm is not None:
        esm.requires_grad_(False).eval()
    return Runtime(cfg, diffuser, model, dcfg, dev, esm)


def load_trunk_weights(model: ScoreNetworkIteration, path: str, cfg
                       ) -> str:
    """Load the trunk's weights from `path` into `model`, strictly, telling
    the file's kind by its content (not its name: the port's trainer
    writes `params.pt`, a released checkpoint is a `.ckpt`):
    - a `torch.save` archive holding `model_state_dict`, or keys of the
      reference ScoreNetwork (`impl.`): a reference checkpoint such as the
      released `abx_diffab.ckpt` / `abx_rabd.ckpt`, converted by
      `utils/torch_convert.py`;
    - any other `torch.save` archive: a state dict by the port's names,
      the weights file of the port's trainer (its EMA weights, or a
      `.raw`);
    - anything else: a flax msgpack checkpoint of the JAX package.
    Returns 'reference', 'port' or 'msgpack'."""
    if not ckpt_lib.is_torch_checkpoint(path):
        params_lib.load_flax_params(model, params_lib.read_msgpack(path))
        return 'msgpack'
    state = torch_convert.read_checkpoint(path)
    if torch_convert.is_reference_state_dict(state):
        torch_convert.load_reference_state_dict(model, state, cfg)
        return 'reference'
    model.load_state_dict(state)
    return 'port'


def _esm_module(cfg, dtype) -> AntibodyESM:
    """The configured ESM2, built on the 'meta' device (no storage)."""
    es = cfg.model.embeddings_and_seqformer.esm
    esm_cfg = ESM2Config(
        num_layers=es.num_layers, embed_dim=es.embed_channel,
        attention_heads=esm2_num_heads(es.embed_channel,
                                       override=es.get('num_heads')))
    return AntibodyESM(esm_cfg, cfg.data.max_antibody_len,
                       sep_pad_num=es.esm_embed.sep_pad_num, dtype=dtype,
                       device='meta')


def _random_esm(cfg, dtype, dev: torch.device, seed: int) -> AntibodyESM:
    """Full-shape ESM2 with random weights, made on the device: every
    parameter, LayerNorm scales included, is 0.02 * N(0, 1) in the compute
    dtype, from a generator on `dev` seeded with `seed` (no host-side copy
    of the 2.8 B weights of ESM2-3B)."""
    esm = _esm_module(cfg, dtype).to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in esm.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return esm


def load_complexes(data_dir: Optional[str],
                   name_idx: Optional[Sequence[str]],
                   pdb_file: Optional[str], runtime: Runtime,
                   use_seqres: bool = False):
    """Yield (feats, meta) for a complex PDB named <code>_<H>_<L>_<AG>.pdb
    (re-indexed onto its SEQRES records with `use_seqres`), or for each
    name of `name_idx` with a `<data_dir>/<name>.npz`."""
    if pdb_file:
        name = os.path.splitext(os.path.basename(pdb_file))[0]
        parts = name.split('_')
        antigens = parts[3].split('|') if len(parts) > 3 else []
        ex = ds.complex_from_pdb(pdb_file, parts[1], parts[2], antigens,
                                 use_seqres=use_seqres)
        prep = ds.prepare_example(ex, runtime.data_config, False)
        if prep is not None:
            yield prep
        return
    if data_dir is None or name_idx is None:
        raise ValueError('load_complexes needs a pdb_file, or a data_dir '
                         'and a name_idx')
    yield from ds.ComplexDataset(data_dir, name_idx, runtime.data_config)


def sample_generator(device: torch.device, seed: int, name: str,
                     sample_idx: int) -> torch.Generator:
    """Per-chunk generator, stable across processes (crc32, not hash())."""
    key = (seed * 1_000_003 + zlib.crc32(name.encode('utf-8'))) * 65_537 \
        + sample_idx
    return torch.Generator(device=device).manual_seed(key % (2**63))


def sample_chunk(sampler: Sampler, feats, generator: torch.Generator,
                 mesh: mesh_lib.Mesh, check: bool = False):
    """One chunk of samples (a device batch of them), this rank's rows of it:
    every rank draws the chunk's initial noise and its per-step draws for
    the whole chunk from `generator` (seeded alike on every rank) and keeps
    its rows, so the chunk's samples do not depend on how many ranks share
    it.  `check` runs the exact-match check of the sharding.  Returns
    (the rows' sampler result, the rows: a slice of the chunk)."""
    c = sampler.config
    prepared = sampler.prepare(feats, generator)
    b, l = prepared['seq'].shape
    k_corr = (c.seq_corrector_steps
              if sampler.diffuser.config.diffuse_seq else 0)
    noise = draw_noise(generator, len(sampler.step_grids()[0]), b, l,
                       sampler.diffuser.seq.num_states, k_corr,
                       device=prepared['seq'].device)
    rows = mesh_lib.batch_sharding(mesh).rows(b, mesh.rank)
    mine = mesh_lib.shard_batch(mesh, prepared)
    if check:
        mesh_lib.check_shards(mesh, prepared, mine)
    noise = {k: v[:, :, rows] if k == 'corr_u' else v[:, rows]
             for k, v in noise.items()}
    return sampler.sample_prepared(mine, generator, noise), rows


def _to_host(result):
    """Sampler result -> numpy; a collected trajectory becomes a dict of
    arrays with a leading step axis."""
    def host(v):
        if not torch.is_tensor(v):
            return np.asarray(v)
        return (v.float() if v.is_floating_point() else v).cpu().numpy()
    out = {k: host(v) for k, v in result.items() if k != 'trajectory'}
    if 'trajectory' in result:
        steps = result['trajectory']
        out['trajectory'] = {k: np.stack([host(st[k]) for st in steps])
                             for k in steps[0]}
    return out


def _first_unfinished(sub_dir: str, name: str, num_samples: int,
                      batch_samples: int) -> int:
    """--resume: the first sample to make, rounded down to a chunk start
    (the chunk's generator is keyed on its first index, so a chunk is
    regenerated whole and identically)."""
    def done(i):
        d = os.path.join(sub_dir, f'{i:04d}')
        # design / optimize write <name>.pdb; trajectory one <name>@<t>.pdb
        # per step.
        return (os.path.exists(os.path.join(d, f'{name}.pdb'))
                or bool(glob.glob(os.path.join(glob.escape(d),
                                               f'{glob.escape(name)}@*.pdb'))))
    i = 0
    while i < num_samples and done(i):
        i += 1
    return (i // batch_samples) * batch_samples


def run_sampling(runtime: Runtime, output_dir: str, complexes,
                 num_samples: int = 1, generate_area: str = 'H3',
                 num_t: Optional[int] = None, seed: int = 42,
                 batch_samples: Optional[int] = None, mode: str = 'design',
                 opt_steps: Sequence[int] = (), resume: bool = False,
                 esm_reuse_recycles: bool = False,
                 esm_refresh_every: int = 1, seq_corrector_steps: int = 0,
                 mesh: Optional[mesh_lib.Mesh] = None
                 ) -> List[Tuple[str, int, float]]:
    """Sample `num_samples` samples of each complex, `batch_samples` at a
    time in the batch axis; writes reference/<name>.pdb and
    <NNNN>/<name>.pdb under `output_dir` -- under OPT-<k>/ for each
    optimize strength k of `opt_steps` in optimize mode, and one
    <name>@<t>.pdb per step in trajectory mode.  `resume` skips the samples
    whose output exists.  `esm_reuse_recycles`, `esm_refresh_every` and
    `seq_corrector_steps` are the sampler's opt-in, output-changing options
    (SamplerConfig).  `mesh`: the ranks of this host that share each
    chunk (`sample_chunk`; default this process alone): a rank writes the
    samples of its rows, rank 0 the reference and a chunk the mesh size
    does not divide; `batch_samples` defaults to the mesh size.  Returns
    (name, n, seconds) per chunk, n this rank's samples."""
    cfg = runtime.config
    num_t = num_t or cfg.diffuser.inference_step
    mesh = mesh or mesh_lib.local_mesh(runtime.device)
    batch_samples = batch_samples or mesh.size
    checked = False
    ref_dir = os.path.join(output_dir, 'reference')
    os.makedirs(ref_dir, exist_ok=True)
    opt_list = list(opt_steps) if mode == 'optimize' else [None]
    complexes = list(complexes)  # reused across optimize strengths
    results_log = []
    for opt_step in opt_list:
        scfg = SamplerConfig(num_t=num_t, generate_area=generate_area,
                             mode=mode, opt_step=opt_step,
                             collect_trajectory=mode == 'trajectory',
                             esm_reuse_recycles=esm_reuse_recycles,
                             esm_refresh_every=esm_refresh_every,
                             seq_corrector_steps=seq_corrector_steps)
        logger.debug('%s', scfg)
        sampler = Sampler(runtime.model, runtime.diffuser, cfg.model, scfg,
                          esm_fn=runtime.esm)
        sub_dir = (os.path.join(output_dir, f'OPT-{opt_step}')
                   if opt_step is not None else output_dir)
        os.makedirs(sub_dir, exist_ok=True)
        for feats, meta in complexes:
            name = meta['name']
            batch = ds.stack_batch([feats])
            if mesh.rank == 0:
                postprocess_reference(ref_dir, meta, batch)
            sample_idx = (_first_unfinished(sub_dir, name, num_samples,
                                            batch_samples) if resume else 0)
            # The ranks start together (another rank may already write).
            sample_idx = mesh_lib.min_over_ranks(mesh, sample_idx)
            if sample_idx:
                logger.info('%s: resuming at sample %d', name, sample_idx)
            while sample_idx < num_samples:
                n = min(batch_samples, num_samples - sample_idx)
                tiled = {k: np.repeat(v, n, axis=0) for k, v in batch.items()}
                gen = sample_generator(runtime.device, seed, name, sample_idx)
                t0 = time.time()
                try:
                    result, rows = sample_chunk(
                        sampler, to_device_batch(tiled, runtime.device),
                        gen, mesh, check=not checked)
                    result = _to_host(result)
                    checked = True
                except Exception:
                    # Per-complex resilience, as the JAX runner: log, go on.
                    logger.exception('sampling failed for %s; skipping',
                                     name)
                    break
                elapsed = time.time() - t0
                mine = rows.stop - rows.start
                logger.info('%s: %d samples in %.2fs (%.2f samples/s)', name,
                            mine, elapsed, mine / elapsed)
                results_log.append((name, mine, elapsed))
                if mine == n and mesh.rank:
                    mine = 0  # a replicated chunk: rank 0 writes it
                for i in range(mine):
                    sdir = os.path.join(sub_dir,
                                        f'{sample_idx + rows.start + i:04d}')
                    os.makedirs(sdir, exist_ok=True)
                    if mode == 'trajectory':
                        postprocess_trajectory(sdir, meta, result, i)
                    else:
                        postprocess_sample(sdir, meta, result, i)
                sample_idx += n
    return results_log
