"""The port's training loop around the model: the optimizer against optax,
the checkpoints, the prefetching pipeline and the training CLI.

* Optimizer: three steps on fixed gradients (the first above the clip)
  against the JAX trainer's `make_optimizer` (global-norm clip, AdamW,
  linear warmup from 0, with and without the cosine decay) and its EMA:
  weights, both moments and the EMA to 1e-6.
* Checkpoints: an atomic save leaves no `.tmp`; a truncated `.train` is an
  error that names it; a resume restores the weights, the moments, the EMA
  and the step.
* Prefetch: the seven cases of tests/test_pipeline.py against the port.
* CLI: the five cases of tests/test_train_cli.py against the port, and
  the same `batch_iterator` seed gives the JAX iterator's names and
  stacked arrays; a tiny CPU run and its resume (`--num_steps` is the
  total), then a design from the weights it wrote.
* Kernel wrappers refuse inputs that require grad: the check itself here
  (the card's test of a wrapper is in tests/test_torch_kernels.py).
"""

import csv
import os
import time

import numpy as np
import optax
import pytest
import torch

from abx_tpu.cli import train as jax_train_cli
from abx_tpu.data import dataset as jax_ds
from abx_tpu.train.trainer import TrainConfig as JaxTrainConfig
from abx_tpu.train.trainer import make_optimizer
from abx_tpu_torch.cli import design as port_design
from abx_tpu_torch.cli import train as port_train_cli
from abx_tpu_torch.data import dataset as port_ds
from abx_tpu_torch.data.pipeline import PrefetchIterator, prefetch
from abx_tpu_torch.ops import _lib
from abx_tpu_torch.sampling.sampler import to_device_batch
from abx_tpu_torch.train.trainer import (TrainConfig, Trainer, TrainState,
                                         learning_rate)
from abx_tpu_torch.utils import checkpoint as ckpt_lib

PDB = 'testdata/6ct7_H_L_S.pdb'
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


# --- optimizer -------------------------------------------------------------

class _Toy(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(
            rng.standard_normal((5, 3)).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.tensor(
            rng.standard_normal(4).astype(np.float32)))


@pytest.mark.parametrize('decay_steps,ema', [(0, 0.9), (3, 0.5), (3, 0.0)])
def test_optimizer_matches_optax(decay_steps, ema):
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    kw = dict(learning_rate=0.1, warmup_steps=2, decay_steps=decay_steps,
              min_lr_ratio=0.2, weight_decay=0.05, grad_clip=1.0,
              ema_decay=ema)
    trainer = Trainer(model, None, None, None, TrainConfig(**kw))
    state = trainer.init_state()
    jcfg = JaxTrainConfig(**kw)
    opt = make_optimizer(jcfg)
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    opt_state = opt.init(params)
    ema_params = dict(params)
    for i, scale in enumerate((30.0, 0.3, 0.05)):   # step 0 is clipped
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        for k, p in model.named_parameters():
            p.grad = torch.tensor(grads[k])
        g_norm = trainer.apply_update(state)
        np.testing.assert_allclose(float(g_norm),
                                   float(optax.global_norm(grads)), rtol=1e-6)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema_params = {k: ema * ema_params[k] + (1.0 - ema) * params[k]
                      for k in params}
        adam = opt_state[1][0]
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), params[k],
                                       **OPT_TOL, err_msg=f'{k} step {i}')
            np.testing.assert_allclose(state.mu[k].numpy(), adam.mu[k],
                                       **OPT_TOL)
            np.testing.assert_allclose(state.nu[k].numpy(), adam.nu[k],
                                       **OPT_TOL)
            if ema > 0:
                np.testing.assert_allclose(state.ema[k].numpy(),
                                           ema_params[k], **OPT_TOL)
        assert state.step == i + 1
    assert (state.ema is None) == (ema == 0)


@pytest.mark.parametrize('warmup,decay', [(1000, 0), (3, 5), (0, 4), (0, 0)])
def test_learning_rate_matches_optax_schedule(warmup, decay):
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, decay_steps=decay,
              min_lr_ratio=0.1)
    if decay > 0:
        want = optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, warmup, warmup + decay, end_value=1e-4)
    else:
        want = optax.linear_schedule(0.0, 1e-3, warmup)
    for count in (0, 1, 2, 3, 5, 9, 2000):
        np.testing.assert_allclose(learning_rate(TrainConfig(**kw), count),
                                   float(want(count)), rtol=1e-6, atol=1e-12)


def test_use_orbax_is_refused(capsys):
    """The port has no orbax checkpoints: the CLI's --help says so, and
    the flag stops the run before anything is built."""
    with pytest.raises(SystemExit):
        port_train_cli.main(['--help'])
    assert 'NOT SUPPORTED' in ' '.join(capsys.readouterr().out.split())
    with pytest.raises(SystemExit):
        port_train_cli.main(['--data_dir', 'x', '--name_idx', 'x',
                             '--output_dir', 'x', '--use_orbax'])
    assert 'orbax checkpoints are JAX-only' in capsys.readouterr().err
    assert 'use_orbax' not in TrainConfig.__dataclass_fields__


# --- checkpoints -----------------------------------------------------------

def _trained_toy(tmp_path):
    model = _Toy(np.random.default_rng(1))
    trainer = Trainer(model, None, None, None, TrainConfig(warmup_steps=1))
    state = trainer.init_state()
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        trainer.apply_update(state)
    path = str(tmp_path / 'ck' / 'params.pt')
    trainer.save(path, state)
    return model, trainer, state, path


def test_save_is_atomic_and_complete(tmp_path):
    model, trainer, state, path = _trained_toy(tmp_path)
    files = sorted(os.listdir(os.path.dirname(path)))
    assert files == ['params.pt', 'params.pt.raw', 'params.pt.train']
    assert ckpt_lib.is_torch_checkpoint(path)
    raw = ckpt_lib.load_params(path + '.raw')
    ema = ckpt_lib.load_params(path)
    for k, p in model.named_parameters():
        assert torch.equal(raw[k], p.detach())
        assert torch.equal(ema[k], state.ema[k])
        assert not torch.equal(ema[k], raw[k])


def test_truncated_train_state_is_an_error_naming_it(tmp_path):
    _, trainer, _, path = _trained_toy(tmp_path)
    data = open(path + '.train', 'rb').read()
    with open(path + '.train', 'wb') as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(RuntimeError, match='params.pt.train'):
        trainer.load_train_state(path)


def test_resume_restores_the_whole_state(tmp_path):
    model, trainer, state, path = _trained_toy(tmp_path)
    fresh = _Toy(np.random.default_rng(9))
    t2 = Trainer(fresh, None, None, None, TrainConfig(warmup_steps=1))
    got = t2.load_train_state(path)
    assert isinstance(got, TrainState) and got.step == state.step == 2
    for k, p in model.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[k], p)
        for a, b in ((got.mu, state.mu), (got.nu, state.nu),
                     (got.ema, state.ema)):
            assert torch.equal(a[k], b[k])


# --- prefetch --------------------------------------------------------------

def _slow_source(n, delay, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise RuntimeError(f'producer failed at {i}')
        time.sleep(delay)
        yield {'x': np.full((4,), i, dtype=np.int32)}


class TestPrefetch:
    def test_order_and_contents_preserved(self):
        got = list(prefetch(_slow_source(7, 0.0), size=3))
        assert len(got) == 7
        for i, item in enumerate(got):
            np.testing.assert_array_equal(item['x'], np.full((4,), i))

    def test_overlaps_producer_with_consumer(self):
        n, delay = 10, 0.02
        it = prefetch(_slow_source(n, delay), size=2)
        t0 = time.perf_counter()
        count = 0
        for _ in it:
            time.sleep(delay)  # simulated device step
            count += 1
        elapsed = time.perf_counter() - t0
        assert count == n
        # Perfect overlap ~1.15x the serial producer time, none 2.0x.
        assert elapsed < 1.9 * n * delay, (
            f'no overlap: {elapsed:.3f}s vs serial {2 * n * delay:.3f}s')

    def test_producer_exception_reraised_at_next(self):
        it = prefetch(_slow_source(10, 0.0, fail_at=3), size=2)
        got = []
        with pytest.raises(RuntimeError, match='producer failed at 3'):
            for item in it:
                got.append(int(item['x'][0]))
        assert got == [0, 1, 2]

    def test_close_unblocks_full_queue(self):
        it = PrefetchIterator(_slow_source(100, 0.0), size=1)
        next(it)
        it.close()  # producer is blocked on a full queue; must not hang
        assert not it._thread.is_alive()
        with pytest.raises(StopIteration):
            next(it)

    def test_size_zero_passthrough(self):
        src = _slow_source(3, 0.0)
        assert prefetch(src, size=0) is src

    def test_device_put_ahead(self):
        got = list(prefetch(_slow_source(3, 0.0), size=2,
                            device_put_ahead=True))
        assert all(isinstance(item['x'], torch.Tensor) for item in got)
        assert got[2]['x'].dtype == torch.int64
        np.testing.assert_array_equal(got[2]['x'].numpy(), np.full((4,), 2))

    def test_device_put_ahead_to_the_given_device(self):
        """The producer moves each array to the device the trainer gives,
        as `to_device_batch` moves it (non-arrays dropped); what it
        delivers is there already, so the step's own move is a no-op."""
        def src():
            for i in range(3):
                yield {'x': np.full((8, 4), i, dtype=np.float64),
                       'name': np.asarray(['a'] * 8)}

        dev = torch.device('cpu')
        got = list(prefetch(src(), size=2, device_put_ahead=True,
                            device=dev))
        assert len(got) == 3
        for i, item in enumerate(got):
            assert item['x'].device == dev and item['x'].dtype == torch.float32
            np.testing.assert_array_equal(item['x'].numpy(),
                                          np.full((8, 4), i))
            assert set(item) == {'x'}
        assert to_device_batch(got[0], dev)['x'] is got[0]['x']


# --- the CLI ---------------------------------------------------------------

@pytest.fixture(scope='module')
def npz_dir(tmp_path_factory):
    """Three npz 'complexes' (copies of the bundled one under new names),
    written by the port's own complex_from_pdb."""
    d = tmp_path_factory.mktemp('npz')
    feats = port_ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    for name in ('cplx_a', 'cplx_b', 'cplx_c'):
        np.savez(d / f'{name}.npz', **feats)
    return d


def _spy_loads(monkeypatch):
    loaded = []
    real = port_ds.load_complex_npz

    def spy(path, name):
        loaded.append(name)
        return real(path, name)
    monkeypatch.setattr(port_ds, 'load_complex_npz', spy)
    return loaded


CFG = port_ds.DataConfig(max_antibody_len=256, max_antigen_len=32)


def test_parse_cluster_file(tmp_path):
    p = tmp_path / 'clusters.txt'
    p.write_text('a b c\n\nd\n e f \n')
    assert port_train_cli.parse_cluster_file(str(p)) == [
        ['a', 'b', 'c'], ['d'], ['e', 'f']]


def test_batch_iterator_static_shapes(npz_dir):
    it = port_train_cli.batch_iterator(
        str(npz_dir), ['cplx_a', 'cplx_b', 'cplx_c'], CFG, batch_size=2,
        is_cluster_idx=False, seed=0)
    b1, b2 = next(it), next(it)
    assert b1['seq'].shape == (2, 288) == b2['seq'].shape
    assert b1['atom14_gt_positions'].shape == (2, 288, 14, 3)


def test_batch_iterator_one_member_per_cluster_per_epoch(npz_dir,
                                                         monkeypatch):
    loaded = _spy_loads(monkeypatch)
    clusters = [['cplx_a', 'cplx_b'], ['cplx_c']]
    it = port_train_cli.batch_iterator(str(npz_dir), clusters, CFG,
                                       batch_size=2, is_cluster_idx=True,
                                       seed=1)
    for _ in range(4):  # 4 epochs' worth
        next(it)
    assert len(loaded) == 8
    for epoch in (loaded[i:i + 2] for i in range(0, 8, 2)):
        assert 'cplx_c' in epoch
        assert len(set(epoch) & {'cplx_a', 'cplx_b'}) == 1


def test_batch_iterator_reduce_num(npz_dir, monkeypatch):
    import random as pyrandom
    loaded = _spy_loads(monkeypatch)
    names = ['cplx_a', 'cplx_b', 'cplx_c']
    it = port_train_cli.batch_iterator(str(npz_dir), names, CFG,
                                       batch_size=2, is_cluster_idx=False,
                                       seed=0, reduce_num=2)
    for _ in range(3):  # 3 epochs x 2 complexes
        next(it)
    assert len(loaded) == 6
    epochs = [loaded[i:i + 2] for i in range(0, 6, 2)]
    for epoch_idx, visited in enumerate(epochs):
        assert len(set(visited)) == 2
        order = list(range(3))
        pyrandom.Random(2022 + epoch_idx).shuffle(order)
        assert visited == [names[i] for i in order[:2]]
    loaded.clear()
    it2 = port_train_cli.batch_iterator(str(npz_dir), names, CFG,
                                        batch_size=2, is_cluster_idx=False,
                                        seed=0, reduce_num=2)
    for _ in range(3):
        next(it2)
    assert [loaded[i:i + 2] for i in range(0, 6, 2)] == epochs


def test_batch_iterator_skips_missing_npz(npz_dir, monkeypatch):
    loaded = _spy_loads(monkeypatch)
    it = port_train_cli.batch_iterator(
        str(npz_dir), ['missing_1', 'cplx_a', 'missing_2'], CFG,
        batch_size=1, is_cluster_idx=False, seed=0)
    for _ in range(3):
        next(it)
    assert loaded == ['cplx_a'] * 3


def test_batch_iterator_matches_jax(npz_dir, monkeypatch):
    """Same seed, same clusters: the same names in the same order and the
    same stacked arrays as the JAX package's iterator (integers exact,
    floats to 1e-6)."""
    seen = {'jax': [], 'port': []}
    for key, mod in (('jax', jax_ds), ('port', port_ds)):
        real = mod.load_complex_npz

        def spy(path, name, _real=real, _key=key):
            seen[_key].append(name)
            return _real(path, name)
        monkeypatch.setattr(mod, 'load_complex_npz', spy)
    clusters = [['cplx_a', 'cplx_b'], ['cplx_c']]
    jcfg = jax_ds.DataConfig(max_antibody_len=256, max_antigen_len=32)
    jit = jax_train_cli.batch_iterator(str(npz_dir), clusters, jcfg, 2, True,
                                       seed=7)
    pit = port_train_cli.batch_iterator(str(npz_dir), clusters, CFG, 2, True,
                                        seed=7)
    for _ in range(3):
        want, got = next(jit), next(pit)
        assert set(got) == set(want)
        for k, w in want.items():
            w, g = np.asarray(w), np.asarray(got[k])
            if w.dtype.kind == 'f':
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
    assert seen['port'] == seen['jax'] and len(seen['port']) == 6


@pytest.fixture
def one_torch_thread():
    """torch's intra-op threads only add contention with the other test
    workers at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_runs_resumes_and_feeds_design(npz_dir, tmp_path,
                                                 one_torch_thread):
    """A tiny CPU run of 1 step, a resume to a total of 2 (one more row,
    step 2), then one design sample from the EMA weights it wrote."""
    (tmp_path / 'names.txt').write_text('cplx_a\ncplx_b\n')
    out = tmp_path / 'run'
    argv = ['--data_dir', str(npz_dir), '--name_idx',
            str(tmp_path / 'names.txt'), '--output_dir', str(out), '--tiny',
            '--device', 'cpu', '--batch_size', '1', '--log_every', '1',
            '--checkpoint_every', '1', '--prefetch', '1']
    state = port_train_cli.main(argv + ['--num_steps', '1'])
    assert state.step == 1
    before = ckpt_lib.load_params(str(out / 'params.pt.raw'))
    state = port_train_cli.main(argv + ['--num_steps', '2', '--resume'])
    assert state.step == 2
    with open(out / 'metrics.csv', newline='') as f:
        rows = list(csv.DictReader(f))
    steps = [r['step'] for r in rows]
    assert all(np.isfinite(float(r['total'])) and float(r['grad_norm']) > 0
               for r in rows)
    assert steps == ['1', '2'], steps
    assert sorted(p.name for p in out.iterdir()) == [
        'metrics.csv', 'params.pt', 'params.pt.raw', 'params.pt.train']
    after = ckpt_lib.load_params(str(out / 'params.pt.raw'))
    assert any(not torch.equal(before[k], after[k]) for k in before)
    port_design.main(['--pdb_file', PDB, '--output_dir', str(tmp_path / 'd'),
                      '--tiny', '--device', 'cpu', '--num_t', '2',
                      '--model', str(out / 'params.pt')])
    assert (tmp_path / 'd' / 'design' / '0000' / '6ct7_H_L_S.pdb').exists()


def test_train_cli_refuses_use_orbax(tmp_path):
    with pytest.raises(SystemExit):
        port_train_cli.main(['--data_dir', str(tmp_path), '--name_idx', 'x',
                             '--output_dir', str(tmp_path), '--use_orbax',
                             '--device', 'cpu'])


# --- kernel wrappers and autograd ------------------------------------------

def test_refuse_autograd_only_with_grad_on_an_input_that_needs_it():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='fused_transition.*no backward'):
        _lib.refuse_autograd('fused_transition', torch.ones(3), x)
    with torch.no_grad():
        _lib.refuse_autograd('fused_transition', x)
    _lib.refuse_autograd('fused_transition', torch.ones(3), None)
