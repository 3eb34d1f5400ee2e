"""The port's SEQRES re-indexing and the CLIs' new flags, against the JAX
package.

A copy of testdata/6ct7_H_L_S.pdb with SEQRES records for chain H and
residues 30-35 of H's ATOM records dropped (as tests/test_data.py builds
it) goes through `parse_seqres`, `expand_to_seqres` and
`complex_from_pdb(use_seqres=True)` of both packages: every array equal.
Then the design CLI on it with `--use_seqres --verbose` (tiny model, CPU),
and both CLIs pass the sampler's three opt-in flags through to
`runner.run_sampling`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from abx_tpu.common import residue_constants as jax_rc
from abx_tpu.data import dataset as jax_ds
from abx_tpu.data import pdb_io as jax_pdb_io
from abx_tpu_torch.cli import design, inference, runner
from abx_tpu_torch.data import dataset as ds
from abx_tpu_torch.data import pdb_io

PDB = 'testdata/6ct7_H_L_S.pdb'


@pytest.fixture(scope='module')
def seqres_pdb(tmp_path_factory):
    """The PDB with SEQRES for chain H and a 6-residue gap in H."""
    h = jax_pdb_io.parse_pdb(PDB)['H']
    three = [jax_rc.restype_1to3[c] for c in h.str_seq]
    lines = [f'SEQRES {i // 13 + 1:>3d} H {len(three):>4d}  '
             + ' '.join(three[i:i + 13]) for i in range(0, len(three), 13)]
    drop = {(r, ' ') for r in h.resseq[30:36]}
    for line in open(PDB, encoding='utf-8').read().splitlines():
        if line[:6] == 'ATOM  ' and line[21] == 'H' and \
                (int(line[22:26]), line[26]) in drop:
            continue
        lines.append(line)
    path = tmp_path_factory.mktemp('seqres') / '6ct7_H_L_S.pdb'
    path.write_text('\n'.join(lines) + '\n')
    return str(path), h.str_seq


def _assert_chain_equal(got, want):
    assert got.chain_id == want.chain_id and got.str_seq == want.str_seq
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.coord_mask, want.coord_mask)
    assert got.resseq == want.resseq and got.icodes == want.icodes


def test_parse_and_expand_to_seqres_match_jax(seqres_pdb):
    path, h_seq = seqres_pdb
    got, want = pdb_io.parse_seqres(path), jax_pdb_io.parse_seqres(path)
    assert got == want and got['H'] == h_seq
    p_chain = pdb_io.parse_pdb(path)['H']
    j_chain = jax_pdb_io.parse_pdb(path)['H']
    assert len(p_chain.str_seq) == len(h_seq) - 6
    full = pdb_io.expand_to_seqres(p_chain, got['H'])
    _assert_chain_equal(full, jax_pdb_io.expand_to_seqres(j_chain, want['H']))
    assert len(full.str_seq) == len(h_seq)
    assert int((~full.coord_mask.any(-1)).sum()) == 6
    # A SEQRES that does not explain the chain keeps the observed view.
    other = 'ACDEFGHIKLMNPQRSTVWY' * 10
    assert pdb_io.expand_to_seqres(p_chain, other) is p_chain


@pytest.mark.parametrize('use_seqres', [True, False])
def test_complex_from_pdb_use_seqres_matches_jax(seqres_pdb, use_seqres):
    path, _ = seqres_pdb
    got = ds.complex_from_pdb(path, 'H', 'L', ['S'], use_seqres=use_seqres)
    want = jax_ds.complex_from_pdb(path, 'H', 'L', ['S'],
                                   use_seqres=use_seqres)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    full = ds.complex_from_pdb(PDB, 'H', 'L', ['S'])
    if use_seqres:
        assert got['antibody_str_seq'] == full['antibody_str_seq']
        assert int((~got['antibody_coord_mask'][:, 1].astype(bool)).sum()) \
            >= 6
    else:
        assert len(got['antibody_str_seq']) < len(full['antibody_str_seq'])


def test_design_cli_use_seqres_verbose_writes_pdbs(seqres_pdb, tmp_path):
    path, _ = seqres_pdb
    out = tmp_path / 'out'
    proc = subprocess.run(
        [sys.executable, '-m', 'abx_tpu_torch.cli.design', '--pdb_file', path,
         '--output_dir', str(out), '--tiny', '--device', 'cpu', '--num_t',
         '2', '--use_seqres', '--verbose'],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert '[DEBUG]' in proc.stderr
    for sub in ('reference', '0000'):
        pdb = out / 'design' / sub / '6ct7_H_L_S.pdb'
        assert pdb.exists(), pdb
        chains = {line[21] for line in pdb.read_text().splitlines()
                  if line.startswith('ATOM')}
        assert chains == {'H', 'L', 'S'}, chains


@pytest.mark.parametrize('cli', ['design', 'inference'])
def test_clis_pass_the_sampler_opt_ins_through(monkeypatch, tmp_path, cli):
    seen = {}
    monkeypatch.setattr(runner, 'build_runtime', lambda *a, **kw: 'rt')

    def load(*a, **kw):
        seen['load'] = kw
        return iter(())
    monkeypatch.setattr(runner, 'load_complexes', load)
    monkeypatch.setattr(runner, 'run_sampling',
                        lambda *a, **kw: seen.update(run=kw) or [])
    flags = ['--esm_reuse_recycles', '--esm_refresh_every', '4',
             '--seq_corrector_steps', '2', '--device', 'cpu']
    if cli == 'design':
        design.main(['--pdb_file', PDB, '--output_dir', str(tmp_path),
                     '--use_seqres'] + flags)
        assert seen['load'] == {'use_seqres': True}
    else:
        names = tmp_path / 'names.txt'
        names.write_text('6ct7_H_L_S\n')
        inference.main(['--data_dir', str(tmp_path), '--name_idx',
                        str(names), '--output_dir', str(tmp_path)] + flags)
    run = seen['run']
    assert (run['esm_reuse_recycles'], run['esm_refresh_every'],
            run['seq_corrector_steps']) == (True, 4, 2)
