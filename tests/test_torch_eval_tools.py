"""The port's copies of the JAX package's host-side evaluation and data
tools give the same outputs as the originals on `testdata/`.

The copies are numpy code (`common/protein.py`, `evaluation/{metrics,
grafting,trajectory}.py`, `preprocess/{make_data,mmcif}.py`,
`cli/{eval_metric,plot,preprocess}.py`): each is held to EQUAL output —
arrays bit for bit, CSV text identical — on the repository's test
complexes, an mmCIF written here, and a small design directory built here
from `testdata/6ct7_H_L_S.pdb` (`make_design_dir`, shared with the relax
and PLL tests).
"""

import csv
import os
import shutil
import sys

import numpy as np
import pytest

from abx_tpu.cli import eval_metric as jax_eval_metric
from abx_tpu.cli import plot as jax_plot
from abx_tpu.common import protein as jax_protein
from abx_tpu.data import pdb_io as jax_pdb_io
from abx_tpu.evaluation import grafting as jax_grafting
from abx_tpu.evaluation import metrics as jax_metrics
from abx_tpu.evaluation import trajectory as jax_traj
from abx_tpu.preprocess import make_data as jax_make_data
from abx_tpu.preprocess import mmcif as jax_mmcif
from abx_tpu_torch.cli import eval_metric as port_eval_metric
from abx_tpu_torch.cli import plot as port_plot
from abx_tpu_torch.cli import preprocess as port_preprocess_cli
from abx_tpu_torch.common import protein as port_protein
from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import ChainData, parse_pdb
from abx_tpu_torch.evaluation import grafting as port_grafting
from abx_tpu_torch.evaluation import metrics as port_metrics
from abx_tpu_torch.evaluation import trajectory as port_traj
from abx_tpu_torch.preprocess import make_data as port_make_data
from abx_tpu_torch.preprocess import mmcif as port_mmcif
from abx_tpu_torch.preprocess.numbering import annotate_domain

HERE = os.path.dirname(os.path.abspath(__file__))
PDB = os.path.join(HERE, '..', 'testdata', '6ct7_H_L_S.pdb')
PDB_6QD7 = os.path.join(HERE, '..', 'testdata', '6qd7_X_Z_F|E.pdb')
NAME = '6ct7_H_L_S'


# --- a small design directory ------------------------------------------------

def _fv(chain: ChainData, tag: str) -> ChainData:
    ann = annotate_domain(chain.str_seq, tag)
    sl = slice(ann.start, ann.end)
    return ChainData(chain.chain_id, chain.str_seq[sl], chain.coords[sl],
                     chain.coord_mask[sl], chain.resseq[sl],
                     chain.icodes[sl])


def designed_chains(seed: int, shift: float = 0.0):
    """The Fv of 6ct7 with its CDR-H3 redesigned: noise on the H3 atoms
    (1.5 A, seeded: clashes for the relaxer), two H3 residues mutated to
    glycine (AAR below 1), the whole complex shifted by `shift` A; the
    antigen S as it is."""
    rng = np.random.default_rng(seed)
    chains = parse_pdb(PDB)
    h, lt = _fv(chains['H'], 'H'), _fv(chains['L'], 'L')
    h3 = np.nonzero(annotate_domain(h.str_seq, 'H').cdr_def
                    == rc.cdr_str_to_enum['H3'])[0]
    coords = h.coords.copy()
    coords[h3] += (1.5 * rng.standard_normal((len(h3), 14, 3))).astype(
        np.float32)
    seq = list(h.str_seq)
    mask = h.coord_mask.copy()
    for i in rng.choice(h3, 2, replace=False):
        seq[i] = 'G'
        mask[i, 4:] = False
    h = ChainData('H', ''.join(seq), coords, mask, h.resseq, h.icodes)
    out = [h, lt, chains['S']]
    return [ChainData(c.chain_id, c.str_seq, c.coords + np.float32(shift),
                      c.coord_mask, c.resseq, c.icodes) for c in out]


def make_design_dir(root, n_designs: int = 2, trajectory: bool = False):
    """<root>/reference/6ct7_H_L_S.pdb (the full complex) and one designed
    complex a sample, <root>/<i:04d>/6ct7_H_L_S.pdb; with `trajectory`,
    three steps `6ct7_H_L_S@<t>.pdb` in <root>/0000 instead."""
    root = str(root)
    os.makedirs(os.path.join(root, 'reference'), exist_ok=True)
    shutil.copy(PDB, os.path.join(root, 'reference', f'{NAME}.pdb'))
    if trajectory:
        os.makedirs(os.path.join(root, '0000'), exist_ok=True)
        for i, t in enumerate(('1.00', '0.50', '0.01')):
            port_traj._write_chains_pdb(
                os.path.join(root, '0000', f'{NAME}@{t}.pdb'),
                designed_chains(10 + i, shift=3.0))
        return root
    for i in range(n_designs):
        os.makedirs(os.path.join(root, f'{i:04d}'), exist_ok=True)
        port_traj._write_chains_pdb(
            os.path.join(root, f'{i:04d}', f'{NAME}.pdb'),
            designed_chains(i))
    return root


def read_csv_rows(path):
    with open(path, newline='', encoding='utf-8') as f:
        return list(csv.DictReader(f))


def run_jax_cli(monkeypatch, main, argv):
    """The JAX package's CLIs read sys.argv."""
    monkeypatch.setattr(sys, 'argv', ['prog'] + argv)
    main()


# --- the copies, module by module --------------------------------------------

def _assert_chain_equal(got, want):
    assert got.chain_id == want.chain_id
    assert got.str_seq == want.str_seq
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.coord_mask, want.coord_mask)
    assert list(got.resseq) == list(want.resseq)
    assert list(got.icodes) == list(want.icodes)


@pytest.mark.parametrize('path', [PDB, PDB_6QD7])
def test_make_complex_features_matches_jax(path):
    parts = os.path.basename(path)[:-4].split('_')
    ag = parts[3].split('|')
    got = port_make_data.make_complex_features(
        parse_pdb(path), parts[1], parts[2], ag)
    want = jax_make_data.make_complex_features(
        jax_pdb_io.parse_pdb(path), parts[1], parts[2], ag)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_preprocess_cli_writes_the_jax_npz(tmp_path, monkeypatch):
    """`cli/preprocess.py` over a SAbDab summary of one entry (PDB format)
    writes the same npz and name index as the JAX package's; with the
    `anarci` package absent, the `anarci` backend drops the complex in
    both packages."""
    struct = tmp_path / 'structs'
    struct.mkdir()
    shutil.copy(PDB, struct / '6ct7.pdb')
    tsv = tmp_path / 'summary.tsv'
    tsv.write_text(
        'pdb\tHchain\tLchain\tmodel\tantigen_chain\tantigen_type\tmethod\n'
        '6ct7\tH\tL\t0\tS\tprotein\tX-RAY DIFFRACTION\n'
        'bad1\tH\tL\t1\tS\tprotein\tX-RAY DIFFRACTION\n')
    outs = []
    for i, main in enumerate((port_preprocess_cli.main,
                              jax_make_data.main)):
        out = tmp_path / f'out{i}'
        main(['--summary_file', str(tsv), '--struct_dir', str(struct),
              '--output_dir', str(out), '--numbering', 'template'])
        outs.append(out)
    assert (outs[0] / 'name_idx.txt').read_text() == \
        (outs[1] / 'name_idx.txt').read_text() == f'{NAME}\n'
    got, want = (np.load(o / f'{NAME}.npz') for o in outs)
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    monkeypatch.setitem(sys.modules, 'anarci', None)   # import fails
    assert port_make_data.make_complex_features(
        parse_pdb(PDB), 'H', 'L', ['S'], numbering_backend='anarci') is None
    assert jax_make_data.make_complex_features(
        jax_pdb_io.parse_pdb(PDB), 'H', 'L', ['S'],
        numbering_backend='anarci') is None


def _mmcif(path, chain, n, observed, scheme=True):
    """An mmCIF of the first n residues of `chain` with coordinates for the
    first `observed` of them, and with `scheme` a _pdbx_poly_seq_scheme
    loop (the full SEQRES), as tests/test_preprocess.py writes one."""
    lines = ['data_test']
    if scheme:
        lines += ['loop_',
                  '_pdbx_poly_seq_scheme.asym_id',
                  '_pdbx_poly_seq_scheme.mon_id',
                  '_pdbx_poly_seq_scheme.pdb_seq_num',
                  '_pdbx_poly_seq_scheme.pdb_ins_code',
                  '_pdbx_poly_seq_scheme.pdb_strand_id']
        for i in range(n):
            lines.append(f'A {rc.restype_1to3[chain.str_seq[i]]} '
                         f'{chain.resseq[i]} . H')
        lines.append('#')
    lines += ['loop_',
              '_atom_site.group_PDB', '_atom_site.id',
              '_atom_site.label_atom_id', '_atom_site.label_alt_id',
              '_atom_site.label_comp_id', '_atom_site.auth_asym_id',
              '_atom_site.auth_seq_id', '_atom_site.pdbx_PDB_ins_code',
              '_atom_site.Cartn_x', '_atom_site.Cartn_y',
              '_atom_site.Cartn_z', '_atom_site.pdbx_PDB_model_num']
    serial = 1
    for i in range(observed):
        resname = rc.restype_1to3[chain.str_seq[i]]
        for j, atom in enumerate(rc.restype_name_to_atom14_names[resname]):
            if not atom or not chain.coord_mask[i, j]:
                continue
            x, y, z = chain.coords[i, j]
            lines.append(f'ATOM {serial} {atom} . {resname} H '
                         f'{chain.resseq[i]} ? {x:.3f} {y:.3f} {z:.3f} 1')
            serial += 1
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


@pytest.mark.parametrize('scheme', [True, False])
def test_parse_mmcif_matches_jax(scheme, tmp_path):
    h = parse_pdb(PDB)['H']
    path = _mmcif(tmp_path / 'x.cif', h, 30, 22 if scheme else 30, scheme)
    got, want = port_mmcif.parse_mmcif(path), jax_mmcif.parse_mmcif(path)
    assert set(got) == set(want) == {'H'}
    _assert_chain_equal(got['H'], want['H'])
    assert got['H'].str_seq == h.str_seq[:30]
    assert got['H'].coord_mask[22:].any() != scheme


def test_calc_ab_metrics_and_make_coords_match_jax():
    rng = np.random.default_rng(1)
    want_ref = jax_metrics.make_coords(PDB, 'H', 'L')
    ref = port_metrics.make_coords(PDB, 'H', 'L')
    assert set(ref) == set(want_ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(want_ref[k]), err_msg=k)
    pred = ref['coords'] + rng.standard_normal(ref['coords'].shape) * 0.8
    seq = list(ref['seq'])
    for i in rng.choice(len(seq), 20, replace=False):
        seq[i] = 'A'
    seq = ''.join(seq)
    mask = ref['mask'] > 0
    got = port_metrics.calc_ab_metrics(ref['coords'], pred, mask,
                                       ref['cdr_def'], ref['seq'], seq)
    want = jax_metrics.calc_ab_metrics(ref['coords'], pred, mask,
                                       ref['cdr_def'], ref['seq'], seq)
    assert got == want
    assert {'h3_rmsd', 'h3_aar', 'l1_rmsd', 'l1_aar'} <= set(got)


_METRIC_CASES = {
    'kabsch': lambda m, a, b: m.kabsch(a, b),
    'aligned_rmsd': lambda m, a, b: m.aligned_rmsd(a, b),
    'gdt': lambda m, a, b: m.gdt(a, b),
    'tm_score': lambda m, a, b: m.tm_score(a, b),
    'lddt_ca': lambda m, a, b: m.lddt_ca(a, b, np.ones(len(a))),
    'contact_precision': lambda m, a, b: m.contact_precision(
        -np.linalg.norm(a[:, None] - a[None], axis=-1),
        np.linalg.norm(b[:, None] - b[None], axis=-1), np.ones(len(a))),
    'mds_from_distogram': lambda m, a, b: m.mds_from_distogram(
        np.linalg.norm(a[:, None] - a[None], axis=-1)),
}


@pytest.mark.parametrize('fn', sorted(_METRIC_CASES))
def test_metric_functions_match_jax(fn):
    h = parse_pdb(PDB)['H']
    b = h.coords[:60, 1].astype(np.float64)
    a = b + np.random.default_rng(2).standard_normal(b.shape)
    got = _METRIC_CASES[fn](port_metrics, a, b)
    want = _METRIC_CASES[fn](jax_metrics, a, b)
    _assert_same(got, want)


def _assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def test_backbone_dihedrals_match_jax():
    h = parse_pdb(PDB)['H']
    got = port_metrics.backbone_dihedrals(h.coords[:50], h.coord_mask[:50])
    want = jax_metrics.backbone_dihedrals(h.coords[:50], h.coord_mask[:50])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_graft_fv_chain_matches_jax():
    chains = parse_pdb(PDB)
    jchains = jax_pdb_io.parse_pdb(PDB)
    designed = designed_chains(3, shift=4.0)[0]
    jdesigned = jax_pdb_io.ChainData(*[getattr(designed, f) for f in (
        'chain_id', 'str_seq', 'coords', 'coord_mask', 'resseq', 'icodes')])
    got = port_grafting.graft_fv_chain(chains['H'], designed, 'H')
    want = jax_grafting.graft_fv_chain(jchains['H'], jdesigned, 'H')
    _assert_chain_equal(got, want)
    np.testing.assert_array_equal(
        port_grafting.graft_fv(chains['H'], designed, 'H'),
        jax_grafting.graft_fv(jchains['H'], jdesigned, 'H'))


def test_protein_to_pdb_matches_jax():
    h = parse_pdb(PDB)['H']
    n = 20
    feats = {'aatype': rc.sequence_to_index(h.str_seq[:n]),
             'residue_index': np.arange(n), 'heavy_len': 12}
    result = {'structure_module': {
        'final_atom_positions': h.coords[:n],
        'final_atom_mask': h.coord_mask[:n].astype(np.float32)}}
    got = port_protein.from_prediction(feats, result)
    want = jax_protein.from_prediction(feats, result)
    assert port_protein.to_pdb(got) == jax_protein.to_pdb(want)


def test_evaluate_trajectory_csv_matches_jax(tmp_path):
    data = make_design_dir(tmp_path / 'traj', trajectory=True)
    orig = tmp_path / 'orig'
    orig.mkdir()
    shutil.copy(PDB, orig / f'{NAME}.pdb')
    texts = []
    for i, lib in enumerate((port_traj, jax_traj)):
        out = str(tmp_path / f'traj{i}.csv')
        rows = lib.evaluate_trajectory(data, out, with_energy=True,
                                       original_dir=str(orig))
        assert len(rows) == 3
        texts.append((open(out).read(), lib.summarize_by_time(rows)))
    assert texts[0] == texts[1]
    rows = read_csv_rows(str(tmp_path / 'traj0.csv'))
    assert {r['grafted'] for r in rows} == {'1'}
    assert all(float(r['full_rmsd']) < 10.0 for r in rows)


def test_eval_metric_results_csv_matches_jax(tmp_path, monkeypatch):
    data = make_design_dir(tmp_path / 'design', n_designs=2)
    outs = [tmp_path / f'out{i}' for i in range(2)]
    for o in outs:
        o.mkdir()
    port_eval_metric.main(['--data_dir', data, '--output_csv',
                           str(outs[0] / 'results.csv'), '--energy'])
    run_jax_cli(monkeypatch, jax_eval_metric.main,
                ['--data_dir', data, '--output_csv',
                 str(outs[1] / 'results.csv'), '--energy'])
    for f in ('results.csv', 'imp.csv'):
        assert (outs[0] / f).read_text() == (outs[1] / f).read_text(), f
    rows = read_csv_rows(str(outs[0] / 'results.csv'))
    assert len(rows) == 2
    for r in rows:
        assert np.isfinite(float(r['full_rmsd']))
        assert 0.0 <= float(r['h3_aar']) < 1.0


def test_plot_helpers_match_jax(tmp_path):
    for rows in ([{'time': '1.0'}], [{'step': '1', 'total': '2'}],
                 [{'h3_rmsd': '1.0'}], [{'pll': '-2.5'}]):
        assert port_plot.detect_kind(rows) == jax_plot.detect_kind(rows)
    with pytest.raises(SystemExit):
        port_plot.detect_kind([{'foo': '1'}])
    rng = np.random.default_rng(4)
    for n in (3, 40):
        data = list(rng.standard_normal(n)) + [50.0]
        assert port_plot.remove_outliers(data) == \
            jax_plot.remove_outliers(data)
    pytest.importorskip('matplotlib')
    path = tmp_path / 'results.csv'
    with open(path, 'w', newline='', encoding='utf-8') as f:
        w = csv.DictWriter(f, fieldnames=['name', 'h3_rmsd', 'h3_aar'])
        w.writeheader()
        for i in range(5):
            w.writerow({'name': f'c{i}', 'h3_rmsd': 1.0 + 0.1 * i,
                        'h3_aar': 0.5})
    port_plot.main(['--csv', str(path)])
    assert os.path.getsize(tmp_path / 'results.png') > 0
