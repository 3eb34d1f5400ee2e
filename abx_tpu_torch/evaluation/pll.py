"""Sequence plausibility via masked pseudo-log-likelihood.

Counterpart of `abx_tpu/evaluation/pll.py`.  Parity surface: the
reference's eval/metric_scripts/calculate_pll.py, which scores designed
sequences with AntiBERTy's per-position masked PLL; here any ESM2-family
model with its LM head computes the same quantity (mask position i, sum
log p(aa_i | rest)).

Each batch holds up to `batch_positions` copies of the tokenised chain
([cls | chain | eos], L = n + 2, no padding), one `<mask>` a row, through
`ESM2.forward(final_only=True)`: on the card every layer's attention is
the hand-written `esm_attention` kernel, so a chain of n residues launches
it num_layers x ceil(n / batch_positions) times.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.models.esm import (AATYPE_TO_ESM, ESM2, ESM_CLS, ESM_EOS,
                                      ESM_MASK, ESM_PAD)


def masked_pll(esm_model: ESM2, lm_head_fn: Callable, seq: str,
               batch_positions: int = 32) -> float:
    """Mean masked pseudo-log-likelihood of a sequence.

    Args:
        esm_model: the encoder, on the device the batches run on.
        lm_head_fn: fn(final_repr (B, L, D)) -> logits (B, L, V).
        seq: amino-acid string.
    """
    n = len(seq)
    aatype = rc.sequence_to_index(seq)
    tokens = np.full((n + 2,), ESM_PAD, np.int64)
    tokens[0] = ESM_CLS
    tokens[1:n + 1] = AATYPE_TO_ESM[np.clip(aatype, 0, rc.restype_num)]
    tokens[n + 1] = ESM_EOS
    dev = esm_model.embed_tokens.weight.device

    total = 0.0
    for start in range(0, n, batch_positions):
        idx = np.arange(start, min(start + batch_positions, n))
        batch = np.tile(tokens[None], (len(idx), 1))
        batch[np.arange(len(idx)), idx + 1] = ESM_MASK
        with torch.no_grad():
            # final_only: only the post-LN last layer feeds the LM head.
            final = esm_model(torch.as_tensor(batch, device=dev),
                              final_only=True)            # (B, L, D)
            logp = torch.log_softmax(lm_head_fn(final).float(), dim=-1)
            rows = torch.as_tensor(np.arange(len(idx)), device=dev)
            pos = torch.as_tensor(idx + 1, device=dev)
            true_tok = torch.as_tensor(tokens[idx + 1], device=dev)
            sel = logp[rows, pos, true_tok]
        total += float(sel.sum())
    return total / n
