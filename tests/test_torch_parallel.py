"""The port's parallelism over processes against one process and the JAX
package, on the CPU (torch.distributed over gloo).

* `shard_names` and `pad_batch_to_devices` equal the JAX functions; the
  mesh's `shard_batch` exact-match check passes over 2 ranks and fails on
  every rank when one rank holds a wrong shard; `replicate` gives rank 0's
  values and `all_gather_rows` the rows in rank order.
* Sampling: a chunk of 4 samples over 2 ranks (`runner.sample_chunk`)
  equals one process's (identical sequences, coordinates to 1e-5 A), and
  `run_sampling` over the 2 ranks writes each sample once.
* Multi-host test-set inference: two `cli.inference` processes with
  `--coordinator/--num_hosts/--host_id` cover the complexes disjointly,
  the union is all of them and no output collides (as
  tests/test_multihost.py holds the JAX CLI).
* Tensor-parallel ESM2: `esm_param_specs` gives each rank the shard the
  JAX `NamedSharding` puts on the matching device; tp 2 and dp 2 x tp 2
  agree with one process's `AntibodyESM` and the JAX `AntibodyESM` on
  bridged weights to 1e-5 of max|ref|.
* Data-parallel training: two steps over 2 ranks equal the one-process
  steps on the whole batch, dropout on as configured: the loss, every
  gradient after the reduction (to 1e-5 of its max), and the weights
  after each update (to 1e-5 of the largest weight).
* `utils/prof.py`: `phase` / `summary` as the JAX module's; `trace` on
  the CPU writes a Chrome trace holding an `annotate` span.

Every child process has a timeout; each runs on one torch thread.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PDB = os.path.join(REPO, 'testdata', '6ct7_H_L_S.pdb')
L_AB, L_AG = 14, 5
TIMEOUT = 240
REL = 1e-5


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _run_ranks(module, case, world, tmp, **kw):
    """Run `<module>._worker(case, rank, world, port, tmp, kw)` in `world`
    gloo processes; every one must exit 0 within TIMEOUT."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c',
         f'import {module} as m; m._worker({case!r}, {r}, {world}, {port}, '
         f'{str(tmp)!r}, {json.dumps(kw)!r})'],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} of {case}:\n{out[-4000:]}'
    return outs


def _join(rank, world, port):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_process_group('gloo', f'127.0.0.1:{port}', world, rank,
                                timeout_s=TIMEOUT)


def _worker(case, rank, world, port, tmp, kw):
    import torch.distributed as dist
    _join(rank, world, port)
    try:
        out = _CASES[case](rank, world, tmp, json.loads(kw))
        torch.save(out, os.path.join(tmp, f'{case}_{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# --- the mesh --------------------------------------------------------------

def test_shard_names_and_pad_match_jax():
    from abx_tpu.data import dataset as jax_ds
    from abx_tpu.parallel import mesh as jax_mesh
    from abx_tpu_torch.data import dataset as port_ds
    from abx_tpu_torch.parallel import mesh as port_mesh
    names = [f'c{i}' for i in range(7)]
    for count in (1, 2, 3, 8):
        for idx in range(count):
            assert port_ds.shard_names(names, idx, count) == \
                jax_ds.shard_names(names, idx, count)
    rng = np.random.default_rng(0)
    batch = {'a': rng.standard_normal((5, 3)).astype(np.float32),
             'b': rng.integers(0, 9, (5,)).astype(np.int32)}
    for d in (1, 2, 4):
        got, n_got = port_mesh.pad_batch_to_devices(batch, d)
        want, n_want = jax_mesh.pad_batch_to_devices(batch, d)
        assert n_got == n_want == 5
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])


def _case_mesh(rank, world, tmp, kw):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh()
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, 'gloo')
    batch = {'x': torch.arange(24, dtype=torch.float32).reshape(8, 3),
             'i': torch.arange(8),
             'odd': torch.arange(3.0),            # undivisible: replicated
             'np': np.arange(16).reshape(8, 2)}
    mine = mesh_lib.shard_batch(mesh, batch)
    assert torch.equal(mine['x'], batch['x'][4 * rank:4 * rank + 4])
    assert torch.equal(mine['odd'], batch['odd'])
    mesh_lib.check_shards(mesh, batch, mine)
    wrong = {**mine, 'x': batch['x'][:4]}      # rank 1 holds rank 0's rows
    try:
        mesh_lib.check_shards(mesh, batch, wrong)
        caught = False
    except RuntimeError:
        caught = True
    got = mesh_lib.replicate(mesh, {'v': torch.full((2,), float(rank))})
    rows = mesh_lib.all_gather_rows(mesh, torch.full((1, 2), float(rank)))
    return {'caught': caught, 'replicated': got['v'], 'gathered': rows}


def test_mesh_shard_check_replicate_gather(tmp_path):
    _run_ranks('tests.test_torch_parallel', 'mesh', 2, tmp_path)
    for r in range(2):
        out = torch.load(tmp_path / f'mesh_{r}.pt')
        # Rank 0's wrong shard is right; rank 1's is not: both ranks fail.
        assert out['caught'], r
        assert torch.equal(out['replicated'], torch.zeros(2))
        assert torch.equal(out['gathered'],
                           torch.tensor([[0.0, 0.0], [1.0, 1.0]]))


# --- sampling --------------------------------------------------------------

def _tiny_runtime():
    """The tiny model at its own shape budget (48 + 8), random weights from
    seed 0, on the CPU."""
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data.dataset import DataConfig
    from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
    from abx_tpu_torch.models.modules import reset_parameters
    from abx_tpu_torch.models.network import ScoreNetworkIteration
    cfg = config_lib.tiny_model_config()
    d = cfg.data
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()))
    model = ScoreNetworkIteration(cfg.model, diffuser, d.max_antibody_len)
    reset_parameters(model, 0)
    dcfg = DataConfig(d.max_antibody_len, d.max_antigen_len, d.patch_radius,
                      d.anchor_neighbors)
    return runner.Runtime(cfg, diffuser, model.eval(), dcfg,
                          torch.device('cpu'))


def _cropped_example():
    """6ct7 with its antibody cropped to residues 80-120, to fit the tiny
    model's 48 + 8 (as tests/test_multihost.py crops it)."""
    from abx_tpu_torch.data import dataset as ds
    ex = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    for k in ['antibody_coords', 'antibody_coord_mask', 'antibody_residx',
              'antibody_chain_ids', 'antibody_cdr_def']:
        ex[k] = ex[k][80:120]
    ex['antibody_str_seq'] = ex['antibody_str_seq'][80:120]
    return ex


def _chunk(rt, mesh, seed=7):
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.sampling.sampler import (Sampler, SamplerConfig,
                                                to_device_batch)
    feats, meta = ds.prepare_example(_cropped_example(), rt.data_config,
                                     False)
    batch = {k: np.repeat(v, 4, axis=0)
             for k, v in ds.stack_batch([feats]).items()}
    sampler = Sampler(rt.model, rt.diffuser, rt.config.model,
                      SamplerConfig(num_t=2, seq_corrector_steps=1))
    gen = runner.sample_generator(rt.device, seed, meta['name'], 0)
    result, rows = runner.sample_chunk(
        sampler, to_device_batch(batch, rt.device), gen, mesh, check=True)
    return {'seq': result['seq'], 'atom14': result['atom14'],
            'rows': (rows.start, rows.stop)}, (feats, meta)


def _case_sampling(rank, world, tmp, kw):
    from abx_tpu_torch.cli import runner
    from abx_tpu_torch.parallel import mesh as mesh_lib
    rt = _tiny_runtime()
    mesh = mesh_lib.make_mesh()
    out, complex_ = _chunk(rt, mesh)
    out['log'] = runner.run_sampling(
        rt, os.path.join(tmp, 'design'), [complex_], num_samples=4,
        num_t=2, seed=0, mesh=mesh)
    return out


def test_two_rank_sampling_equals_one_process(tmp_path):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    _run_ranks('tests.test_torch_parallel', 'sampling', 2, tmp_path)
    torch.set_num_threads(1)
    want, (_, meta) = _chunk(_tiny_runtime(), mesh_lib.local_mesh('cpu'))
    parts = [torch.load(tmp_path / f'sampling_{r}.pt') for r in range(2)]
    assert [p['rows'] for p in parts] == [(0, 2), (2, 4)]
    seq = torch.cat([p['seq'] for p in parts])
    atom14 = torch.cat([p['atom14'] for p in parts])
    assert torch.equal(seq, want['seq'])
    assert (atom14 - want['atom14']).abs().max().item() <= 1e-5
    # run_sampling: two samples a rank (batch_samples = the mesh size),
    # every sample written once, the reference by rank 0.
    for p in parts:
        assert [n for _, n, _ in p['log']] == [1, 1]
    name = meta['name']
    for sub in ('reference', '0000', '0001', '0002', '0003'):
        assert (tmp_path / 'design' / sub / f'{name}.pdb').exists(), sub


def test_multihost_inference_cli_coverage(tmp_path):
    from abx_tpu_torch.data import dataset as ds
    ex = _cropped_example()
    names = [f'c{i}_H_L_S' for i in range(2)]
    feats = {k: v for k, v in ex.items() if k != 'name'}
    for nm in names:
        np.savez(tmp_path / f'{nm}.npz', **feats)
    idx = tmp_path / 'names.idx'
    idx.write_text('\n'.join(names) + '\n')
    assert ds.prepare_example(ex, ds.DataConfig(256, 32), False) is not None
    out_dir = tmp_path / 'out'
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'abx_tpu_torch.cli.inference',
         '--data_dir', str(tmp_path), '--name_idx', str(idx),
         '--output_dir', str(out_dir), '--mode', 'design',
         '--num_samples', '1', '--num_t', '1', '--tiny', '--device', 'cpu',
         '--coordinator', f'127.0.0.1:{port}', '--num_hosts', '2',
         '--host_id', str(h)], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for h, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'host {h}:\n{out[-4000:]}'
    owned = [{nm for nm in names if f'{nm}: 1 samples' in out}
             for out in outs]
    assert owned[0].isdisjoint(owned[1])
    assert owned[0] | owned[1] == set(names)
    assert owned == [{names[0]}, {names[1]}]     # round-robin
    design = out_dir / 'design'
    written = sorted(os.listdir(design / '0000'))
    assert written == sorted(f'{nm}.pdb' for nm in names)
    assert sorted(os.listdir(design / 'reference')) == written


# --- tensor-parallel ESM2 --------------------------------------------------

ESM_B, ESM_L_AB, ESM_SEP = 4, 20, 4


def _esm_inputs():
    rng = np.random.default_rng(3)
    aatype = rng.integers(0, 21, (ESM_B, ESM_L_AB)).astype(np.int64)
    heavy = np.array([12, 9, 7, 10], np.int64)
    light = np.array([8, 6, 10, 9], np.int64)
    weights = rng.standard_normal(3).astype(np.float32)   # 2 layers + 1
    return aatype, heavy, light, weights


def _jax_esm_tree():
    import jax
    import jax.numpy as jnp
    from abx_tpu.models import esm as jax_esm
    from abx_tpu_torch.utils import params as params_lib
    model = jax_esm.ESM2(jax_esm.ESM2Config.tiny(), scan_layers=False)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 30), jnp.int32)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return params_lib.dense_random_tree(zeros, 5, scale=1.0)


def _case_esm(rank, world, tmp, kw):
    from abx_tpu_torch.models.esm import ESM2Config
    from abx_tpu_torch.parallel import esm_tp
    from abx_tpu_torch.utils import params as params_lib
    state = dict(np.load(os.path.join(tmp, 'esm_state.npz')))
    mesh = esm_tp.mesh2d(kw['dp'], kw['tp'], device='cpu')
    assert (mesh.data.size, mesh.model.size) == (kw['dp'], kw['tp'])
    esm = esm_tp.TensorParallelAntibodyESM(
        mesh, ESM2Config.tiny(), ESM_L_AB, sep_pad_num=ESM_SEP,
        dtype=torch.float32, device='meta')
    params_lib.load_esm_params(esm.module,
                               esm_tp.shard_esm_params(mesh, state), 'cpu',
                               torch.float32)
    heads = {esm.module.layers[0].self_attn.q_proj.out_features
             // esm.module.layers[0].self_attn.head_dim}
    aatype, heavy, light, weights = _esm_inputs()
    from abx_tpu_torch.parallel import mesh as mesh_lib
    ins = mesh_lib.shard_batch(mesh.data, {
        'a': torch.tensor(aatype), 'h': torch.tensor(heavy),
        'l': torch.tensor(light)})
    with torch.no_grad():
        out = esm.eval()(ins['a'], ins['h'], ins['l'], torch.tensor(weights))
    return {'out': out, 'heads': heads, 'dp_rank': mesh.data.rank}


@pytest.mark.parametrize('dp,tp', [(1, 2), (2, 2)])
def test_tensor_parallel_esm_matches_one_process_and_jax(tmp_path, dp, tp):
    import jax
    import jax.numpy as jnp
    from abx_tpu.models import esm as jax_esm
    from abx_tpu_torch.models import esm as port_esm
    from abx_tpu_torch.utils import params as params_lib
    tree = _jax_esm_tree()
    state = params_lib.esm_flax_to_state_dict(tree)
    np.savez(tmp_path / 'esm_state.npz', **state)
    _run_ranks('tests.test_torch_parallel', 'esm', dp * tp, tmp_path,
               dp=dp, tp=tp)
    aatype, heavy, light, weights = _esm_inputs()
    one = port_esm.AntibodyESM(port_esm.ESM2Config.tiny(), ESM_L_AB,
                               sep_pad_num=ESM_SEP, dtype=torch.float32,
                               device='meta')
    params_lib.load_esm_params(one.module, state, 'cpu', torch.float32)
    with torch.no_grad():
        want = one.eval()(torch.tensor(aatype), torch.tensor(heavy),
                          torch.tensor(light), torch.tensor(weights)).numpy()
    jesm = jax_esm.AntibodyESM(jax_esm.ESM2Config.tiny(), ESM_L_AB,
                               sep_pad_num=ESM_SEP, dtype=jnp.float32,
                               scan_layers=False)
    jwant = np.asarray(jesm(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(aatype.astype(np.int32)),
        jnp.asarray(heavy.astype(np.int32)),
        jnp.asarray(light.astype(np.int32)), jnp.asarray(weights)))
    scale = np.abs(want).max()
    assert np.abs(want - jwant).max() <= REL * scale
    rows = ESM_B // dp
    for r in range(dp * tp):
        got = torch.load(tmp_path / f'esm_{r}.pt')
        assert got['heads'] == {4 // tp}
        d = got['dp_rank']
        ref = want[d * rows:(d + 1) * rows]
        assert np.abs(got['out'].numpy() - ref).max() <= REL * scale, r
        assert np.abs(got['out'].numpy()
                      - jwant[d * rows:(d + 1) * rows]).max() <= REL * scale


def test_esm_param_specs_match_jax_named_sharding():
    import jax
    from abx_tpu.parallel import esm_tp as jax_tp
    from abx_tpu_torch.parallel import esm_tp as port_tp
    from abx_tpu_torch.parallel import mesh as port_mesh
    from abx_tpu_torch.utils import params as params_lib
    tree = _jax_esm_tree()
    jmesh = jax_tp.mesh2d(1, 2)
    sharded = jax_tp.shard_esm_params(jmesh, jax.tree.map(np.asarray, tree))
    devices = list(jmesh.devices.reshape(-1))
    state = params_lib.esm_flax_to_state_dict(tree)
    port = []
    for r in range(2):
        m = port_mesh.Mesh(None, r, 2, torch.device('cpu'), None, 'model')
        mesh = port_tp.Mesh2D(port_mesh.local_mesh('cpu'), m)
        port.append(port_tp.shard_esm_params(mesh, state))
    # Each device's shard of the JAX tree, bridged to fair-esm names.
    for r, dev in enumerate(devices):
        local = jax.tree.map(
            lambda x: np.asarray(next(s.data for s in x.addressable_shards
                                      if s.device == dev)), sharded)
        want = params_lib.esm_flax_to_state_dict(local)
        assert set(want) == set(port[r])
        for k, v in want.items():
            np.testing.assert_array_equal(port[r][k].numpy(), v, err_msg=k)
    specs = port_tp.esm_param_specs(state)
    assert specs['layers.0.self_attn.q_proj.weight'] == -2
    assert specs['layers.0.fc1.bias'] == -1
    assert specs['layers.1.fc2.weight'] == -1
    assert specs['layers.1.fc2.bias'] is None
    assert specs['embed_tokens.weight'] is None


# --- data-parallel training ------------------------------------------------

def _train_feats(b=4, seed=0):
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


def _train_two_steps(mesh):
    """Two steps of the tiny model (dropout as configured) on the 4-example
    batch, this rank's rows of it; the first step's metrics and summed
    gradients, and the weights after each step."""
    from abx_tpu_torch import config as config_lib
    from abx_tpu_torch.diffusion.joint import JointConfig, JointDiffuser
    from abx_tpu_torch.models.modules import reset_parameters
    from abx_tpu_torch.models.network import ScoreNetworkIteration
    from abx_tpu_torch.parallel import mesh as mesh_lib
    from abx_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = config_lib.tiny_model_config()
    diffuser = JointDiffuser(JointConfig.from_dict(cfg.diffuser.to_dict()))
    model = ScoreNetworkIteration(cfg.model, diffuser, L_AB)
    reset_parameters(model, 0)
    trainer = Trainer(model, diffuser, cfg.model, cfg.loss,
                      TrainConfig(learning_rate=1e-3, warmup_steps=0,
                                  decay_steps=10, generate_area='H3'),
                      mesh=mesh)
    state = trainer.init_state()
    feats = mesh_lib.shard_batch(mesh, _train_feats())
    gen = torch.Generator().manual_seed(3)
    out = {'weights': []}
    for i in range(2):
        metrics = trainer.step(state, feats, gen)
        if i == 0:
            out['metrics'] = {k: float(v) for k, v in metrics.items()
                              if k.startswith(('rigids/', 'seq/', 'folding/',
                                               'distogram/', 'plddt/'))
                              or k in ('total', 'grad_norm', 'num_recycle')}
            out['grads'] = {k: p.grad.clone()
                            for k, p in trainer._params().items()}
        out['weights'].append({k: p.detach().clone()
                               for k, p in trainer._params().items()})
    return out


def _case_train(rank, world, tmp, kw):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    return _train_two_steps(mesh_lib.make_mesh())


def test_two_rank_training_step_equals_one_process(tmp_path):
    from abx_tpu_torch.parallel import mesh as mesh_lib
    _run_ranks('tests.test_torch_parallel', 'train', 2, tmp_path)
    torch.set_num_threads(1)
    want = _train_two_steps(mesh_lib.local_mesh('cpu'))
    for r in range(2):
        got = torch.load(tmp_path / f'train_{r}.pt')
        assert set(got['metrics']) == set(want['metrics'])
        for k, v in want['metrics'].items():
            assert abs(got['metrics'][k] - v) <= REL * max(abs(v), 1e-6), k
        for k, g in want['grads'].items():
            scale = max(g.abs().max().item(), 1e-12)
            assert (got['grads'][k] - g).abs().max().item() <= REL * scale, k
        # The weights after each update, to 1e-5 of their largest value.
        for step, (gw, ww) in enumerate(zip(got['weights'],
                                            want['weights'])):
            scale = max(w.abs().max().item() for w in ww.values())
            for k, w in ww.items():
                err = (gw[k] - w).abs().max().item()
                assert err <= REL * scale, (step, k, err, scale)
    moved = [k for k, w in want['weights'][0].items()
             if not torch.equal(w, want['weights'][1][k])]
    assert len(moved) > 0.8 * len(want['weights'][0])


def _case_train_cli(rank, world, tmp, kw):
    from abx_tpu_torch.cli import train
    from abx_tpu_torch.train.trainer import Trainer
    trainers = []
    fit = Trainer.fit

    def keep(self, *args, **kwargs):        # the CLI's Trainer, for its weights
        trainers.append(self)
        return fit(self, *args, **kwargs)
    Trainer.fit = keep
    state = train.main([
        '--data_dir', tmp, '--name_idx', os.path.join(tmp, 'names.idx'),
        '--output_dir', os.path.join(tmp, 'run'), '--tiny', '--device',
        'cpu', '--batch_size', '2', '--num_steps', '1', '--log_every', '1',
        '--prefetch', '0'])
    return {'step': state.step, 'mesh': (trainers[0].mesh.rank,
                                         trainers[0].mesh.size),
            'weights': {k: p.detach().clone()
                        for k, p in trainers[0]._params().items()}}


def test_train_cli_under_a_process_group(tmp_path):
    """cli/train.py in 2 gloo ranks: each loads its own name's rows, both
    end at the same weights, rank 0 alone writes the run's files."""
    ex = _cropped_example()
    feats = {k: v for k, v in ex.items() if k != 'name'}
    for nm in ('c0_H_L_S', 'c1_H_L_S'):
        np.savez(tmp_path / f'{nm}.npz', **feats)
    (tmp_path / 'names.idx').write_text('c0_H_L_S\nc1_H_L_S\n')
    _run_ranks('tests.test_torch_parallel', 'train_cli', 2, tmp_path)
    got = [torch.load(tmp_path / f'train_cli_{r}.pt') for r in range(2)]
    assert got[0]['step'] == got[1]['step'] == 1
    assert [g['mesh'] for g in got] == [(0, 2), (1, 2)]
    for k, w in got[0]['weights'].items():
        assert torch.equal(w, got[1]['weights'][k]), k
    assert sorted(os.listdir(tmp_path / 'run')) == [
        'metrics.csv', 'params.pt', 'params.pt.raw', 'params.pt.train']
    rows = (tmp_path / 'run' / 'metrics.csv').read_text().splitlines()
    assert len(rows) == 2                        # the header and one step


# --- utils/prof.py ---------------------------------------------------------

def test_prof_phase_and_summary_match_jax():
    from abx_tpu.utils import prof as jax_prof
    from abx_tpu_torch.utils import prof as port_prof
    jax_prof.summary(reset=True)
    port_prof.summary(reset=True)
    for mod in (jax_prof, port_prof):
        for name in ('data', 'sample', 'data'):
            with mod.phase(name):
                pass
        with pytest.raises(ValueError):
            with mod.phase('post'):
                raise ValueError('counted all the same')
    got, want = port_prof.summary(), jax_prof.summary(reset=True)
    assert set(got) == set(want) == {'data', 'sample', 'post'}
    for k in want:
        assert got[k]['count'] == want[k]['count']
        assert set(got[k]) == set(want[k]) == {'total_s', 'count', 'mean_s'}
    assert port_prof.summary(reset=True)['data']['count'] == 2
    assert port_prof.summary() == {}


def test_prof_trace_writes_an_annotated_chrome_trace(tmp_path):
    from abx_tpu_torch.utils import prof
    with prof.trace(str(tmp_path)):
        with prof.annotate('abx_trunk_pass'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / 'trace.json').read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'abx_trunk_pass' in names


_CASES = {'mesh': _case_mesh, 'sampling': _case_sampling, 'esm': _case_esm,
          'train': _case_train, 'train_cli': _case_train_cli}
