"""Antibody variable-domain annotation: IMGT regions without heavy deps.

The port's own copy of `abx_tpu/preprocess/numbering.py`, with the same
names and the same backends:

  * `anarci` — used automatically when the `anarci` package is importable;
    exact IMGT numbering.
  * `template` — a dependency-free fit: the query against germline
    consensus templates whose region labels are known, framework segments
    placed ungapped and in order, and the CDRs are the spans between them.
  * `abnum` — the remote AbNum (Chothia) lookup, opt-in only
    (`backend='abnum'` or `ABX_ALLOW_REMOTE=1`; the fetch is injectable).
    Its semi-global alignment runs in Python: it is one small alignment
    per lookup, which waits on the network anyway, so the port keeps no
    counterpart of the JAX package's C helper.

Region enum (reference residue_constants.py): per chain,
fr1=0 cdr1=1 fr2=2 cdr2=3 fr3=4 cdr3=5 fr4=6, light-chain labels offset +7.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Templates: (sequence, region string) — same length; region chars:
# 1=fr1 A=cdr1 2=fr2 B=cdr2 3=fr3 C=cdr3 4=fr4.
_HEAVY_TEMPLATE = (
    'EVQLLESGGGLVQPGGSLRLSCAAS' 'GFTFSSYA' 'MSWVRQAPGKGLEWVSA' 'ISGSGGST'
    'YYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYC' 'AKGGGGYFDY' 'WGQGTLVTVSS',
    '1' * 25 + 'A' * 8 + '2' * 17 + 'B' * 8 + '3' * 38 + 'C' * 10 + '4' * 11,
)
_KAPPA_TEMPLATE = (
    'DIQMTQSPSSLSASVGDRVTITCRAS' 'QSISSY' 'LNWYQQKPGKAPKLLIY' 'AAS'
    'SLQSGVPSRFSGSGSGTDFTLTISSLQPEDFATYYC' 'QQSYSTPLT' 'FGQGTKVEIK',
    '1' * 26 + 'A' * 6 + '2' * 17 + 'B' * 3 + '3' * 36 + 'C' * 9 + '4' * 10,
)
_LAMBDA_TEMPLATE = (
    'QSALTQPASVSGSPGQSITISCTGT' 'SSDVGGYNY' 'VSWYQQHPGKAPKLMIY' 'DVS'
    'KRPSGVSNRFSGSKSGNTASLTISGLQAEDEADYYC' 'SSYTSSSTLV' 'FGGGTKLTVL',
    '1' * 25 + 'A' * 9 + '2' * 17 + 'B' * 3 + '3' * 36 + 'C' * 10 + '4' * 10,
)

_REGION_TO_ENUM = {'1': 0, 'A': 1, '2': 2, 'B': 3, '3': 4, 'C': 5, '4': 6}


@dataclasses.dataclass
class DomainAnnotation:
    start: int                # domain start in the input sequence
    end: int                  # domain end (exclusive)
    cdr_def: np.ndarray       # (end-start,) region enums (chain-offset added)
    numbering: Optional[list] = None  # IMGT numbers when anarci backend


def _align_semiglobal(query: str, template: str,
                      match: int = 2, mismatch: int = -1, gap: int = -2
                      ) -> List[Tuple[int, int]]:
    """Semi-global NW: free end-gaps in the query (template aligns inside).

    Returns list of (query_idx, template_idx) aligned pairs.
    """
    nq, nt = len(query), len(template)
    score = np.zeros((nq + 1, nt + 1), dtype=np.int32)
    ptr = np.zeros((nq + 1, nt + 1), dtype=np.int8)  # 0 diag, 1 up, 2 left
    # Free leading query gaps (rows), penalised template gaps (cols).
    for j in range(1, nt + 1):
        score[0, j] = score[0, j - 1] + gap
        ptr[0, j] = 2
    for i in range(1, nq + 1):
        ptr[i, 0] = 1
    for i in range(1, nq + 1):
        qc = query[i - 1]
        for j in range(1, nt + 1):
            s = match if qc == template[j - 1] else mismatch
            diag = score[i - 1, j - 1] + s
            up = score[i - 1, j] + (gap if 0 < j < nt else 0)
            left = score[i, j - 1] + gap
            best = max(diag, up, left)
            score[i, j] = best
            ptr[i, j] = 0 if best == diag else (1 if best == up else 2)
    # Traceback from best score in the last column (free trailing query gap).
    i = int(np.argmax(score[:, nt]))
    j = nt
    pairs = []
    while i > 0 and j > 0:
        p = ptr[i, j]
        if p == 0:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif p == 1:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return pairs


def _anchored_framework_fit(seq: str, tmpl_seq: str, tmpl_regions: str):
    """Place the template's FRAMEWORK segments ungapped, in order, on `seq`.

    Framework indels are biologically exceptional (IMGT frameworks are
    fixed-length); modelling frameworks as rigid ungapped blocks makes every
    CDR boundary exact by construction — the CDR is simply the query span
    BETWEEN two placed frameworks.

    Returns (score, offsets, fr_segments) or None; offsets[k] is the query
    start of framework k.
    """
    frs = []   # (region_char, tmpl_segment, following_cdr_len)
    order = []
    for c, r in zip(tmpl_seq, tmpl_regions):
        if not order or order[-1][0] != r:
            order.append([r, ''])
        order[-1][1] += c
    for idx, (r, s) in enumerate(order):
        if r in '1234':
            nxt = order[idx + 1][1] if idx + 1 < len(order) else ''
            cdr_len = len(nxt) if idx + 1 < len(order) and \
                order[idx + 1][0] in 'ABC' else 0
            frs.append((r, s, cdr_len))

    lq = len(seq)
    match, mismatch, lam = 2.0, -1.0, 0.5
    # Per-segment ungapped match profile over query offsets.
    profiles = []
    for _, s, _ in frs:
        ls = len(s)
        if lq < ls:
            return None  # query shorter than a framework segment
        prof = np.full((lq - ls + 1,), -1e9)
        for o in range(lq - ls + 1):
            sc = 0.0
            for a, b in zip(seq[o:o + ls], s):
                sc += match if a == b else mismatch
            prof[o] = sc
        if prof.size == 0:
            return None
        profiles.append(prof)

    # DP over segment placements with ordering + CDR-length prior.
    n = len(frs)
    best_prev = profiles[0].copy()          # f(0, o)
    back = []
    for k in range(1, n):
        len_prev = len(frs[k - 1][1])
        cdr_prior = frs[k - 1][2]
        cur = np.full_like(profiles[k], -1e9)
        arg = np.zeros(profiles[k].shape, dtype=np.int64)
        for o in range(profiles[k].size):
            lo_max = o - len_prev  # previous segment must END by o
            if lo_max < 0:
                continue
            prev_slice = best_prev[:lo_max + 1]
            gaps = o - (np.arange(lo_max + 1) + len_prev)
            cand = prev_slice - lam * np.abs(gaps - cdr_prior)
            j = int(np.argmax(cand))
            cur[o] = cand[j] + profiles[k][o]
            arg[o] = j
        back.append(arg)
        best_prev = cur

    o_last = int(np.argmax(best_prev))
    score = float(best_prev[o_last])
    if score <= -1e8:
        return None
    offsets = [0] * n
    offsets[-1] = o_last
    for k in range(n - 1, 0, -1):
        offsets[k - 1] = int(back[k - 1][offsets[k]])
    return score, offsets, frs


def _template_annotate(seq: str, chain: str) -> Optional[DomainAnnotation]:
    templates = ([_HEAVY_TEMPLATE] if chain == 'H'
                 else [_KAPPA_TEMPLATE, _LAMBDA_TEMPLATE])
    best = None
    for tmpl_seq, tmpl_regions in templates:
        fit = _anchored_framework_fit(seq, tmpl_seq, tmpl_regions)
        if fit is None:
            continue
        if best is None or fit[0] > best[0]:
            best = fit + (tmpl_seq,)
    if best is None:
        return None
    score, offsets, frs, tmpl_seq = best
    # Identity threshold over framework columns (the anchoring signal).
    n_fr = sum(len(s) for _, s, _ in frs)
    n_match = sum(1 for (_, s, _), o in zip(frs, offsets)
                  for a, b in zip(seq[o:o + len(s)], s) if a == b)
    if n_match < 0.45 * n_fr:
        return None  # not an antibody variable domain

    start = offsets[0]
    end = offsets[-1] + len(frs[-1][1])
    labels = np.full((end - start,), -1, dtype=np.int32)
    for (r, s, _), o in zip(frs, offsets):
        labels[o - start:o - start + len(s)] = _REGION_TO_ENUM[r]
    # Inter-framework spans ARE the CDRs: fr_k .. fr_{k+1} -> cdr_k.
    for k in range(len(frs) - 1):
        lo = offsets[k] + len(frs[k][1]) - start
        hi = offsets[k + 1] - start
        labels[lo:hi] = 2 * k + 1  # cdr1=1, cdr2=3, cdr3=5
    if chain != 'H':
        labels = labels + 7
    return DomainAnnotation(start=start, end=end, cdr_def=labels)


def _fill_neighbor_labels(labels: np.ndarray) -> None:
    """In-place: unlabeled (-1) positions inherit a neighbour label,
    preferring the CDR side (insertions live in loops).  Works for both
    heavy (0-6) and light (+7 offset) label ranges via mod-7."""
    for k in range(len(labels)):
        if labels[k] == -1:
            left = labels[:k][labels[:k] >= 0]
            right = labels[k:][labels[k:] >= 0]
            lv = int(left[-1]) if left.size else -1
            rv = int(right[0]) if right.size else -1
            if lv >= 0 and lv % 7 in (1, 3, 5):
                labels[k] = lv
            elif rv >= 0 and rv % 7 in (1, 3, 5):
                labels[k] = rv
            else:
                labels[k] = lv if lv >= 0 else rv


def _anarci_annotate(seq: str, chain: str) -> Optional[DomainAnnotation]:
    try:
        from anarci import anarci  # type: ignore
    except ImportError:
        return None
    allow = ['H'] if chain == 'H' else ['K', 'L']
    try:
        numbering, _, _ = anarci([('A', seq)], scheme='imgt', allow=allow)
    except Exception:
        return None  # broken/stubbed anarci installation
    if numbering[0] is None:
        return None
    domain_numbering, start, end = numbering[0][0]
    end += 1
    domain_numbering = [x[0] for x in domain_numbering if x[1] != '-']
    labels = np.full((len(domain_numbering),), -1, dtype=np.int32)
    bounds = [('fr1', 1, 26, 0), ('cdr1', 27, 38, 1), ('fr2', 39, 55, 2),
              ('cdr2', 56, 65, 3), ('fr3', 66, 104, 4), ('cdr3', 105, 117, 5),
              ('fr4', 118, 128, 6)]
    for i, (num, _) in enumerate(domain_numbering):
        for _, lo, hi, enum in bounds:
            if lo <= num <= hi:
                labels[i] = enum
                break
    if chain != 'H':
        labels = labels + 7
    return DomainAnnotation(start=start, end=end, cdr_def=labels,
                            numbering=domain_numbering)


ABNUM_URL = 'http://www.bioinf.org.uk/abs/abnum/abnum.cgi'


def _parse_abnum_response(text: str, chain: str
                          ) -> Optional[Tuple[np.ndarray, str]]:
    """Parse an AbNum (Chothia-numbering) response into region labels.

    AbNum returns one "<chain><number><ins> <aa>" pair per line (e.g.
    "H26 G").  Chothia CDR windows: H1 26-32, H2 52-56, H3 95-102; L1
    24-34, L2 50-56, L3 89-97.

    Returns (labels, numbered_seq): region enums (chain offset applied) for
    each numbered residue, plus the numbered subsequence itself so the
    caller can anchor the domain within the full chain.  '-' rows (scheme
    positions with no residue) carry no query residue and are skipped.
    """
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) != 2 or not parts[0][1:2].isdigit():
            continue
        if parts[1] == '-':
            continue
        rows.append((int(''.join(c for c in parts[0][1:] if c.isdigit())),
                     parts[1]))
    if not rows:
        return None
    windows = ([(26, 32, 1), (52, 56, 3), (95, 102, 5)] if chain == 'H'
               else [(24, 34, 1), (50, 56, 3), (89, 97, 5)])
    labels = np.zeros((len(rows),), dtype=np.int32)
    # framework labels by position relative to the CDR windows
    for i, (num, _) in enumerate(rows):
        lab = None
        for lo, hi, enum in windows:
            if lo <= num <= hi:
                lab = enum
                break
            if num < lo:
                lab = enum - 1   # framework before this CDR
                break
        if lab is None:
            lab = 6              # fr4
        labels[i] = lab
    if chain != 'H':
        labels = labels + 7
    return labels, ''.join(aa for _, aa in rows)


def _abnum_annotate(seq: str, chain: str,
                    fetch=None) -> Optional[DomainAnnotation]:
    """Remote AbNum lookup.

    Network access is off by default; set ABX_ALLOW_REMOTE=1 to allow it.
    `fetch` is injectable (called with the request URL, returns the
    response text); None on any failure.
    """
    import os
    if fetch is None:
        if os.environ.get('ABX_ALLOW_REMOTE', '0') != '1':
            return None

        def fetch(url):
            import urllib.request
            with urllib.request.urlopen(url, timeout=20) as r:
                return r.read().decode('utf-8', errors='replace')

    import urllib.parse
    query = urllib.parse.urlencode(
        {'plain': 1, 'scheme': '-c', 'aaseq': seq})
    try:
        text = fetch(f'{ABNUM_URL}?{query}')
    except Exception:
        return None
    parsed = _parse_abnum_response(text, chain)
    if parsed is None:
        return None
    labels, sub = parsed
    # AbNum numbers only the variable domain; anchor it in the full chain so
    # leading/trailing residues do not shift the CDR labels.
    start = seq.find(sub)
    if start >= 0:
        return DomainAnnotation(start=start, end=start + len(sub),
                                cdr_def=labels)
    # Mid-domain residues AbNum could not number break contiguity: align the
    # numbered subsequence into the chain and transfer labels through it,
    # keeping placeholder labels for the unnumbered positions.
    pairs = _align_semiglobal(seq, sub)
    if not pairs:
        return None
    n_match = sum(seq[qi] == sub[ti] for qi, ti in pairs)
    if n_match < 0.8 * len(sub):
        return None  # response does not correspond to this chain
    start = pairs[0][0]
    end = pairs[-1][0] + 1
    out = np.full((end - start,), -1, dtype=np.int32)
    for qi, ti in pairs:
        out[qi - start] = labels[ti]
    _fill_neighbor_labels(out)
    return DomainAnnotation(start=start, end=end, cdr_def=out)


BACKENDS = ('auto', 'anarci', 'template', 'abnum')


def annotate_domain(seq: str, chain: str,
                    backend: str = 'auto') -> Optional[DomainAnnotation]:
    """Annotate the variable domain of an antibody chain sequence.

    Args:
        seq: full chain sequence (1-letter codes).
        chain: 'H' or 'L'.
        backend: 'anarci', 'template', 'abnum', or 'auto' (anarci when
            available, then the template fit; the remote AbNum backend is
            opt-in — explicit backend='abnum' or ABX_ALLOW_REMOTE=1 as a
            last resort).
    Returns None when no backend numbers the chain.
    """
    if backend == 'abnum':
        return _abnum_annotate(seq, chain)
    if backend in ('auto', 'anarci'):
        ann = _anarci_annotate(seq, chain)
        if ann is not None:
            return ann
        if backend == 'anarci':
            return None
    ann = _template_annotate(seq, chain)
    if ann is None and backend == 'auto':
        ann = _abnum_annotate(seq, chain)  # opt-in remote last resort
    return ann
