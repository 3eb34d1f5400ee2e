"""The port's numbering backends against the JAX package's.

`annotate_domain` of `abx_tpu_torch/preprocess/numbering.py` against that of
`abx_tpu/preprocess/numbering.py` on every backend: the template fit on the
chains of both test complexes; the remote AbNum backend on canned responses
through an injected fetch (no network); ANARCI through one stub `anarci`
module put in `sys.modules` for both packages; and the port's semi-global
aligner against both of the JAX package's (its C helper and its Python
path).
"""

import sys
import types

import numpy as np
import pytest

from abx_tpu import native as jax_native
from abx_tpu.preprocess import numbering as jax_nb
from abx_tpu_torch.data.pdb_io import parse_pdb
from abx_tpu_torch.preprocess import numbering as port_nb

COMPLEXES = [('testdata/6ct7_H_L_S.pdb', 'H', 'L'),
             ('testdata/6qd7_X_Z_F|E.pdb', 'X', 'Z')]
CHAINS = [(path, cid, tag) for path, h, l in COMPLEXES
          for cid, tag in ((h, 'H'), (l, 'L'))]


def _seq(path, cid):
    return parse_pdb(path)[cid].str_seq


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert (got.start, got.end) == (want.start, want.end)
    assert got.cdr_def.dtype == want.cdr_def.dtype
    np.testing.assert_array_equal(got.cdr_def, want.cdr_def)
    assert got.numbering == want.numbering


@pytest.fixture
def no_remote(monkeypatch):
    monkeypatch.delenv('ABX_ALLOW_REMOTE', raising=False)


@pytest.mark.parametrize('backend', ['template', 'auto'])
@pytest.mark.parametrize('path,cid,tag', CHAINS)
def test_template_backend_matches_jax(path, cid, tag, backend, no_remote,
                                      monkeypatch):
    monkeypatch.setitem(sys.modules, 'anarci', None)   # not installed
    seq = _seq(path, cid)
    want = jax_nb.annotate_domain(seq, tag, backend=backend)
    assert want is not None
    _assert_same(port_nb.annotate_domain(seq, tag, backend=backend), want)


def test_no_backend_numbers_a_non_antibody(no_remote, monkeypatch):
    monkeypatch.setitem(sys.modules, 'anarci', None)
    seq = 'MKT' * 40
    for backend in ('auto', 'template', 'anarci', 'abnum'):
        assert jax_nb.annotate_domain(seq, 'H', backend=backend) is None
        assert port_nb.annotate_domain(seq, 'H', backend=backend) is None


# --- AbNum: the canned responses of tests/test_preprocess.py, copied ------

def _fake_response(chain='H'):
    """A Chothia-numbered domain, one "<chain><number> <aa>" row a residue:
    fr1 (1-25), cdr1 (26-32), fr2 (33-51), cdr2 (52-56), fr3 (57-94), cdr3
    (95-102), fr4 (103+) for a heavy chain."""
    lines, seq = [], []
    for num in range(1, 110):
        aa = 'ACDEFGHIKLMNPQRSTVWY'[num % 20]
        lines.append(f'{chain}{num} {aa}')
        seq.append(aa)
    return '\n'.join(lines), ''.join(seq)


def _abnum_cases():
    text, sub = _fake_response()
    light, lsub = _fake_response('L')
    with_gaps = text.replace('H40 ', 'H40A -\nH40 ', 1) + '\nH110 -'

    def boom(url):
        raise OSError('no network')
    return {
        'domain': (sub, 'H', lambda url: text),
        'anchored_in_chain': ('MGWS' + sub + 'AKTT', 'H', lambda url: text),
        'unnumbered_midchain_residue': (sub[:60] + 'W' + sub[60:], 'H',
                                        lambda url: text),
        'light_chain': (lsub, 'L', lambda url: light),
        'gap_rows': (sub, 'H', lambda url: with_gaps),
        'unrelated_response': ('EVQLVESGGGLVQPGGSLRLSCAASGFTF' * 3, 'H',
                               lambda url: text),
        'empty_response': (sub, 'H', lambda url: 'no numbering\n'),
        'fetch_fails': (sub, 'H', boom),
    }


@pytest.mark.parametrize('case', sorted(_abnum_cases()))
def test_abnum_backend_matches_jax(case):
    seq, chain, fetch = _abnum_cases()[case]
    want = jax_nb._abnum_annotate(seq, chain, fetch=fetch)
    if case in ('domain', 'anchored_in_chain', 'light_chain',
                'unnumbered_midchain_residue'):
        assert want is not None
    _assert_same(port_nb._abnum_annotate(seq, chain, fetch=fetch), want)
    assert port_nb.ABNUM_URL == jax_nb.ABNUM_URL


def test_abnum_request_and_opt_in(no_remote):
    """The same request URL, and no request without the opt-in."""
    urls = {}
    text, sub = _fake_response()
    for name, nb in (('jax', jax_nb), ('port', port_nb)):
        def fetch(url, name=name):
            urls[name] = url
            return text
        nb._abnum_annotate(sub, 'H', fetch=fetch)
        assert nb.annotate_domain(sub, 'H', backend='abnum') is None
    assert urls['port'] == urls['jax']


# --- ANARCI, through one stub module for both packages --------------------

def _stub_anarci(mode):
    """An `anarci` module whose `anarci()` numbers the chain from its second
    residue to at most its 120th, IMGT-like: a gap row ('-') every 17th
    position and insertion codes at 111-112, as ANARCI returns them."""
    mod = types.ModuleType('anarci')
    calls = []

    def anarci(seqs, scheme='imgt', allow=None, **kwargs):
        calls.append((scheme, tuple(allow)))
        if mode == 'raises':
            raise RuntimeError('hmmscan: command not found')
        name, seq = seqs[0]
        if mode == 'none':
            return [None], [None], None
        start, end = 1, min(len(seq) - 1, 120)
        rows, num = [], 1
        for i in range(start, end + 1):
            if num % 17 == 0:
                rows.append(((num, ' '), '-'))
                num += 1
            ins = 'A' if num in (111, 112) and i % 2 else ' '
            rows.append(((num, ins), seq[i]))
            num += ins == ' '
        return [[(rows, start, end)]], [[{'chain_type': allow[0]}]], None
    mod.anarci = anarci
    mod.calls = calls
    return mod


@pytest.mark.parametrize('mode', ['numbers', 'none', 'raises'])
@pytest.mark.parametrize('backend', ['anarci', 'auto'])
@pytest.mark.parametrize('path,cid,tag', CHAINS[:2])
def test_anarci_backend_matches_jax(path, cid, tag, backend, mode, no_remote,
                                    monkeypatch):
    stub = _stub_anarci(mode)
    monkeypatch.setitem(sys.modules, 'anarci', stub)
    seq = _seq(path, cid)
    want = jax_nb.annotate_domain(seq, tag, backend=backend)
    got = port_nb.annotate_domain(seq, tag, backend=backend)
    _assert_same(got, want)
    assert stub.calls[0] == stub.calls[1] == (
        'imgt', ('H',) if tag == 'H' else ('K', 'L'))
    if mode == 'numbers':
        assert got.numbering is not None and (got.cdr_def >= 0).all()
    elif backend == 'anarci':
        assert got is None
    else:                       # auto falls back to the template fit
        assert got is not None and got.numbering is None


# --- the semi-global aligner, three ways -----------------------------------

def _pairs():
    rng = np.random.default_rng(3)
    aas = 'ACDEFGHIKLMNPQRSTVWY'
    heavy = port_nb._HEAVY_TEMPLATE[0]
    mutated = ''.join(aas[rng.integers(20)] if rng.random() < 0.2 else c
                      for c in heavy)
    _, sub = _fake_response()
    return [
        (_seq(*CHAINS[0][:2]), heavy),
        (_seq(*CHAINS[1][:2]), port_nb._KAPPA_TEMPLATE[0]),
        ('MGWS' + mutated + 'AKTT', heavy),
        (sub[:60] + 'W' + sub[60:], sub),
        (''.join(aas[i] for i in rng.integers(0, 20, 90)),
         ''.join(aas[i] for i in rng.integers(0, 20, 40))),
        ('GGGG', 'GGGGGG'),
    ]


@pytest.mark.parametrize('k', range(6))
def test_aligners_give_the_same_pairs(k, monkeypatch):
    query, template = _pairs()[k]
    got = port_nb._align_semiglobal(query, template)
    # The JAX package's aligner on its C helper where that builds ...
    assert got == jax_nb._align_semiglobal(query, template)
    # ... and on its Python path.
    monkeypatch.setattr(jax_native, 'nw_align', lambda *a, **kw: None)
    assert got == jax_nb._align_semiglobal(query, template)
