"""The port's gradient relaxer and violation energy against the JAX
package's (`abx_tpu/evaluation/relax.py`), and the relax / violation CLIs.

f32 on the CPU, the port on one torch thread.  Inputs: a 40-residue crop
of chain H of testdata/6ct7_H_L_S.pdb with 1.2 A of seeded noise on
residues 25-32 (the movable region; it clashes), and the design directory
of tests/test_torch_eval_tools.py.  Tolerances:
- `violation_energy`, its terms and its gradient (`jax.grad` against
  autograd): 1e-5 relative (the gradient per element, relative to its
  largest element);
- the relaxer at RelaxConfig(iterations=20) against `jax_relax` (optax
  Adam against torch.optim.Adam): coordinates within 1e-4 A, metrics
  within 1e-5 relative; atoms of immobile residues bitwise unchanged;
- the CLIs on the same design directory: the violation CSVs equal to
  1e-5 relative, the relaxed PDBs' coordinates within 2e-3 A (their
  three printed decimals) and every other column identical.  The relax
  CLI runs 2 relax iterations on both sides (the relaxer, patched in each
  CLI module, with `iterations=2`): the 200 of the CLIs' RelaxConfig on a
  231-residue complex take minutes of CPU; the relaxer's own parity is
  the test above.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abx_tpu.cli import eval_violations as jax_eval_violations
from abx_tpu.cli import relax_pdb as jax_relax_pdb
from abx_tpu.evaluation import relax as jax_relax_lib
from abx_tpu_torch.cli import eval_violations as port_eval_violations
from abx_tpu_torch.cli import relax_pdb as port_relax_pdb
from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import parse_pdb
from abx_tpu_torch.evaluation import relax as port_relax
from tests.test_torch_eval_tools import (PDB, make_design_dir, read_csv_rows,
                                         run_jax_cli)

N, MOVE = 40, slice(25, 33)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """torch's intra-op threads slow these small autograd steps down
    (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def crop():
    h = parse_pdb(PDB)['H']
    rng = np.random.default_rng(0)
    atom14 = h.coords[:N].copy()
    atom14[MOVE] += (1.2 * rng.standard_normal((8, 14, 3))).astype(
        np.float32)
    move = np.zeros((N,), np.float32)
    move[MOVE] = 1.0
    return (atom14, rc.sequence_to_index(h.str_seq[:N]),
            h.coord_mask[:N].astype(np.float32), np.arange(N), move)


def test_violation_energy_and_gradient_match_jax(crop):
    atom14, seq, exists, residx, _ = crop

    def jax_total(x):
        return jax_relax_lib.violation_energy(
            x, jnp.asarray(seq), jnp.asarray(exists), jnp.asarray(residx))

    (want, want_terms), want_grad = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))(jnp.asarray(atom14))
    want_grad = np.asarray(want_grad)
    x = torch.tensor(atom14, requires_grad=True)
    got, got_terms = port_relax.violation_energy(
        x, torch.tensor(seq), torch.tensor(exists), torch.tensor(residx))
    got.backward()
    got, got_terms = got.detach(), {k: v.detach()
                                    for k, v in got_terms.items()}
    assert float(want_terms['clash']) > 0.0     # the noise clashes
    for k in ('bond', 'clash', 'within'):
        np.testing.assert_allclose(float(got_terms[k]),
                                   float(want_terms[k]), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    err = np.abs(x.grad.numpy() - want_grad).max()
    assert err <= 1e-5 * np.abs(want_grad).max(), err


def test_gradient_relax_matches_jax_relax(crop):
    atom14, seq, exists, residx, move = crop
    want, want_m = jax_relax_lib.jax_relax(
        atom14, seq, exists, residx, move,
        jax_relax_lib.RelaxConfig(iterations=20))
    got, got_m = port_relax.gradient_relax(
        atom14, seq, exists, residx, move,
        port_relax.RelaxConfig(iterations=20), device='cpu')
    assert got.dtype == np.float32 and got.shape == atom14.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - atom14).max() > 1e-2          # it moved
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5,
                                   err_msg=k)
    assert got_m['energy_after'] < got_m['energy_before']
    fixed = move == 0
    assert np.array_equal(got[fixed].view(np.uint32),
                          atom14[fixed].view(np.uint32))


def test_gradient_relax_defaults_to_the_card(crop):
    """The relaxer's device is cuda unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: nothing to refuse')
    with pytest.raises((RuntimeError, AssertionError)):
        port_relax.gradient_relax(*crop)


def _short_relax(lib_module, name, fn, config_cls, monkeypatch, **kw):
    monkeypatch.setattr(lib_module, name, functools.partial(
        fn, config=config_cls(iterations=2), **kw))


def _pdb_columns(path):
    """(non-coordinate text, coordinates) of each ATOM line."""
    rows = [ln for ln in open(path).read().splitlines()
            if ln.startswith('ATOM')]
    text = [ln[:30] + ln[54:] for ln in rows]
    xyz = np.array([[float(ln[30 + 8 * i:38 + 8 * i]) for i in range(3)]
                    for ln in rows])
    return text, xyz


def test_relax_pdb_cli_matches_jax(tmp_path, monkeypatch):
    data = make_design_dir(tmp_path / 'design', n_designs=1)
    outs = [str(tmp_path / f'relaxed{i}') for i in range(2)]
    _short_relax(jax_relax_pdb, 'jax_relax', jax_relax_lib.jax_relax,
                 jax_relax_lib.RelaxConfig, monkeypatch)
    _short_relax(port_relax_pdb, 'gradient_relax',
                 port_relax.gradient_relax, port_relax.RelaxConfig,
                 monkeypatch)
    port_relax_pdb.main(['--data_dir', data, '--output_dir', outs[0],
                         '--device', 'cpu'])
    run_jax_cli(monkeypatch, jax_relax_pdb.main,
                ['--data_dir', data, '--output_dir', outs[1]])
    rel = os.path.join('0000', '6ct7_H_L_S_relaxed.pdb')
    (t0, x0), (t1, x1) = (_pdb_columns(os.path.join(o, rel)) for o in outs)
    assert t0 == t1
    np.testing.assert_allclose(x0, x1, rtol=0, atol=2e-3)
    _, before = _pdb_columns(os.path.join(data, '0000', '6ct7_H_L_S.pdb'))
    assert np.abs(x0 - before).max() > 1e-3           # the CDRs moved


def test_eval_violations_cli_matches_jax(tmp_path, monkeypatch):
    data = make_design_dir(tmp_path / 'design', n_designs=2)
    outs = [str(tmp_path / f'violations{i}.csv') for i in range(2)]
    port_eval_violations.main(['--data_dir', data, '--output_csv', outs[0],
                               '--device', 'cpu'])
    run_jax_cli(monkeypatch, jax_eval_violations.main,
                ['--data_dir', data, '--output_csv', outs[1]])
    got, want = (sorted(read_csv_rows(o), key=lambda r: r['file'])
                 for o in outs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ('name', 'file'):
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=1e-5, err_msg=k)
    assert all(float(r['clash']) > 0.0 for r in got)


@pytest.mark.parametrize('main', [port_relax_pdb.main,
                                  port_eval_violations.main])
def test_cli_default_device_needs_a_card(main, tmp_path):
    """`--device` defaults to cuda and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: nothing to refuse')
    with pytest.raises(RuntimeError, match='--device cuda'):
        main(['--data_dir', str(tmp_path)])
