"""Antibody variable-domain annotation without heavy dependencies.

The port's own copy of the template backend of
`abx_tpu/preprocess/numbering.py`, with the same names: the query is fitted
to germline consensus templates whose region labels are known, framework
segments placed ungapped and in order, and the CDRs are the spans between
them.  This is pure numpy.  The JAX package's `auto` backend tries ANARCI
first, then this template fit, then an opt-in remote AbNum lookup (the only
caller of its semi-global alignment and of the optional C helper in
`abx_tpu/native`); without ANARCI installed and without the opt-in, both
packages annotate every chain with this template fit.

Region enum (reference residue_constants.py): per chain,
fr1=0 cdr1=1 fr2=2 cdr2=3 fr3=4 cdr3=5 fr4=6, light-chain labels offset +7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def annotate_domain(seq: str, chain: str) -> Optional[DomainAnnotation]:
    """Annotate the variable domain of an antibody chain sequence.

    Args:
        seq: full chain sequence (1-letter codes).
        chain: 'H' or 'L'.
    Returns None when the chain does not fit any template.
    """
    return _template_annotate(seq, chain)
