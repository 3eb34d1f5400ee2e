"""The program's spans (`abx_tpu_torch/utils/prof.py::annotate`) in one
design step of a tiny model with a 2-layer ESM2 (L = 30, num_recycle 2),
in the default design, with ESM off and with `esm_reuse_recycles`: their
names, counts and nesting under `torch.profiler`, that no
`record_function` is entered while no profiler records, and that the
step's outputs are bitwise the same with the profiler on and off.  The
file imports no JAX, so its `gpu` test (the spans under `emit_nvtx`) runs
on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""

import collections

import numpy as np
import pytest
import torch

from abx_tpu_torch import config as port_config
from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
from abx_tpu_torch.models import esm as port_esm
from abx_tpu_torch.models.network import ScoreNetworkIteration
from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                            to_device_batch)
from abx_tpu_torch.utils import prof

L_AB, L_AG = 24, 6
MODES = {'default': dict(esm=True),
         'no_esm': dict(esm=False),
         'esm_reuse': dict(esm=True, esm_reuse_recycles=True)}


def _complex():
    rng = np.random.RandomState(0)
    l = L_AB + L_AG
    anchor = np.zeros((1, L_AB), np.int32)
    anchor[:, 6] = anchor[:, 14] = 5
    return {
        'seq': rng.randint(0, 20, (1, l)).astype(np.int32),
        'mask': np.ones((1, l), np.float32),
        'atom14_gt_positions': (5.0 * rng.randn(1, l, 14, 3)).astype(
            np.float32),
        'atom14_gt_exists': np.ones((1, l, 14), np.float32),
        'cdr_def': np.zeros((1, l), np.int32),
        'chain_id': np.zeros((1, l), np.int32),
        'residx': np.arange(l, dtype=np.int32)[None],
        'anchor_flag': anchor,
        'heavy_len': np.full((1,), 14, np.int32),
        'light_len': np.full((1,), 10, np.int32),
    }


def _sampler(esm: bool, esm_reuse_recycles: bool = False):
    """The tiny model at num_recycle 2 (and the tiny ESM2) with dense random
    weights, in a num_t 3 design sampler."""
    cfg = port_config.tiny_model_config()
    cfg.model.num_recycle = 2
    esm_fn = None
    if esm:
        tiny = port_esm.ESM2Config.tiny()
        es = cfg.model.embeddings_and_seqformer.esm
        es.enabled = True
        es.num_layers, es.embed_channel = tiny.num_layers, tiny.embed_dim
        esm_fn = port_esm.AntibodyESM(tiny, L_AB, sep_pad_num=4,
                                      dtype=torch.float32).eval()
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()))
    model = ScoreNetworkIteration(cfg.model, diffuser, L_AB).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in (model, esm_fn):
            for p in (mod.parameters() if mod is not None else ()):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return Sampler(model, diffuser, cfg.model,
                   SamplerConfig(num_t=3,
                                 esm_reuse_recycles=esm_reuse_recycles),
                   esm_fn=esm_fn), cfg


def _step(sampler, profiled: bool):
    """One ordinary step (grid position 1) from a fixed start: (new state,
    outputs, the `abx.` spans as (name, start, end) when `profiled`, the
    number of `torch.profiler.record_function` calls)."""
    gen = torch.Generator().manual_seed(5)
    traj, state = sampler._start(sampler.prepare(
        to_device_batch(_complex(), 'cpu'), gen))
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    torch.profiler.record_function = counted
    try:
        with torch.no_grad():
            if not profiled:
                return (*sampler.step(traj, state, np.full(1, 1), gen),
                        None, len(entered))
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as p:
                new, out = sampler.step(traj, state, np.full(1, 1), gen)
    finally:
        torch.profiler.record_function = real
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in p.profiler.kineto_results.events()
             if e.name().startswith('abx.')]
    return new, out, spans, len(entered)


@pytest.fixture(scope='module')
def runs():
    """Per mode: the sampler's config and the plain and profiled step."""
    cache = {}

    def get(mode):
        if mode not in cache:
            torch.manual_seed(0)
            sampler, cfg = _sampler(**MODES[mode])
            cache[mode] = (cfg, _step(sampler, False), _step(sampler, True))
        return cache[mode]
    return get


def _want_counts(cfg, mode):
    es = cfg.model.embeddings_and_seqformer
    passes = cfg.model.num_recycle + 1
    blocks = es.seqformer_num_block
    want = {'abx.step': 1, 'abx.pass': passes, 'abx.update': 1,
            'abx.trunk': passes, 'abx.trunk.embed': passes,
            'abx.trunk.seq_attn': passes * blocks,
            'abx.trunk.transition': 2 * passes * blocks,
            'abx.trunk.opm': passes * blocks,
            'abx.trunk.tri_mult': 2 * passes * blocks,
            'abx.trunk.tri_attn': 2 * passes * blocks,
            'abx.ipa': passes,
            'abx.ipa.attn': passes
            * cfg.model.heads.diffusion_module.IPA.num_layer,
            'abx.heads': passes}
    if MODES[mode]['esm']:
        forwards = 1 if mode == 'esm_reuse' else passes
        n = es.esm.num_layers
        want.update({'abx.esm': forwards,
                     'abx.esm.norm': (2 * n + 1) * forwards,
                     'abx.esm.attn': n * forwards,
                     'abx.esm.ffn': n * forwards,
                     'abx.esm.mix': (n + 2) * forwards})
    return want


@pytest.mark.parametrize('mode', sorted(MODES))
def test_step_opens_each_span_its_number_of_times(runs, mode):
    cfg, _, (_, _, spans, entered) = runs(mode)
    got = collections.Counter(name for name, _, _ in spans)
    want = _want_counts(cfg, mode)
    assert dict(got) == want
    assert got['abx.esm.norm'] == (2 * 2 + 1) * {'default': 3, 'no_esm': 0,
                                                  'esm_reuse': 1}[mode]
    assert entered == sum(want.values())


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


@pytest.mark.parametrize('mode', sorted(MODES))
def test_spans_nest_as_the_layers_do(runs, mode):
    _, _, (_, _, spans, _) = runs(mode)
    by = collections.defaultdict(list)
    for s in spans:
        by[s[0]].append(s)
    step, = by['abx.step']
    update, = by['abx.update']
    assert all(_inside(p, step) for p in by['abx.pass'])
    assert _inside(update, step)
    assert all(update[1] >= p[2] for p in by['abx.pass'])
    for esm in by['abx.esm']:
        in_pass = any(_inside(esm, p) for p in by['abx.pass'])
        assert in_pass == (mode == 'default')
        assert _inside(esm, step)
    for child, parent in (('abx.esm.', 'abx.esm'), ('abx.trunk.', 'abx.trunk'),
                          ('abx.ipa.', 'abx.ipa'), ('abx.trunk', 'abx.pass'),
                          ('abx.ipa', 'abx.pass'), ('abx.heads', 'abx.pass')):
        for s in spans:
            if s[0].startswith(child):
                assert any(_inside(s, p) for p in by[parent]), (s, parent)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_no_record_function_without_a_profiler(runs, mode):
    _, (_, _, _, entered), _ = runs(mode)
    assert entered == 0


@pytest.mark.parametrize('mode', sorted(MODES))
def test_step_outputs_are_bitwise_the_same_under_the_profiler(runs, mode):
    _, (state, out, _, _), (state_p, out_p, _, _) = runs(mode)
    for got, want in ((state_p, state), (out_p, out)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize('recorder', ['profile', 'trace', 'none'])
def test_annotate_records_only_under_a_profiler(recorder, tmp_path):
    if recorder == 'none':
        assert prof.annotate('abx.x') is prof.annotate('abx.y')
        assert not isinstance(prof.annotate('abx.x'),
                              torch.profiler.record_function)
        return
    ctx = (torch.profiler.profile() if recorder == 'profile'
           else prof.trace(str(tmp_path)))
    with ctx:
        span = prof.annotate('abx.x')
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(4) + 1


@pytest.mark.gpu
def test_annotate_records_under_emit_nvtx():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (emit_nvtx needs CUDA)')
    assert not isinstance(prof.annotate('abx.x'),
                          torch.profiler.record_function)
    with torch.autograd.profiler.emit_nvtx():
        span = prof.annotate('abx.x')
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(4, device='cuda') + 1
    torch.cuda.synchronize()
