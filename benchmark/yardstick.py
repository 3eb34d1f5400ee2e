"""The yardstick: the card's peaks, the roofline bound, and the operations
and bytes of the work the per-layer metrics divide by.

The peaks and `bound_ms` / `tensor_bytes` are copied from `chip_smoke.py`
(phase 3).  `flops_per_step` is `abx_tpu_torch/tools/bench.py`'s
`analytic_flops_per_step`, corrected term by term against the port's
modules (see each term); the counts are of the tensor-core products and
the attention products, elementwise work excluded.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, dense, at its 700 W limit: bf16 tensor-core peak and
# HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def tensor_bytes(tensors) -> int:
    """Bytes of the distinct tensors (each read or written once)."""
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, 'operations' or 'bytes'): bf16 tensor-core peak
    for the products, HBM bandwidth for the bytes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


# -- one module call ----------------------------------------------------------

def tri_attention_core_flops(b: int, n: int, c: int) -> float:
    """A triangle attention's q / k / v / gate / out projections (c -> c
    each, key dim c = heads x head dim) and its QK^T and PV over n rows of
    n x n: the function of kernel row 1 (`triangle_attention_packed`)."""
    return 10.0 * b * n * n * c * c + 4.0 * b * n * n * n * c


def tri_attention_flops(b: int, n: int, c: int, heads: int) -> float:
    """One `TriangleAttention` call: the core and the pair-bias projection
    (c -> heads)."""
    return tri_attention_core_flops(b, n, c) + 2.0 * b * n * n * c * heads


def tri_attention_bytes(b: int, n: int, c: int, heads: int,
                        act: int = 2, param: int = 4) -> float:
    """Distinct bytes of one `TriangleAttention` call: the pair tensor read
    once (it is also the residual) and written once, and the parameters
    (LayerNorm, five c x c projections with the gate's and the out
    projection's biases, the bias projection) and the sequence mask."""
    params = 2 * c + 5 * c * c + 2 * c + c * heads
    return 2.0 * b * n * n * c * act + params * param + b * n * 4


def esm_attention_core_flops(b: int, heads: int, n: int, d: int) -> float:
    """QK^T and PV of one ESM2 attention (kernel row 12)."""
    return 4.0 * b * heads * n * n * d


def esm_attention_core_bytes(b: int, heads: int, n: int, d: int,
                             act: int = 2) -> float:
    """q, k, v read and the output written once (kernel row 12)."""
    return 4.0 * b * heads * n * d * act


def esm_self_attention_flops(b: int, n: int, dim: int) -> float:
    """One `ESMSelfAttention` call: q / k / v / out projections (dim ->
    dim) and the attention core."""
    return 8.0 * b * n * dim * dim + 4.0 * b * n * n * dim


def esm_self_attention_bytes(b: int, n: int, dim: int,
                             act: int = 2) -> float:
    """Its input read and output written once, its four weights and
    biases (bf16), and the padding mask."""
    return (2.0 * b * n * dim * act + (4 * dim * dim + 4 * dim) * act
            + b * n)


# -- one diffusion step ------------------------------------------------------

def _cfg(cfg, *keys):
    for k in keys:
        cfg = cfg[k]
    return cfg


def trunk_pass_flops(cfg: Dict, n: int) -> float:
    """Products of one trunk pass of one sample (embedding, Seqformer
    blocks, structure module, heads) at n residues, from the configuration
    (the JSON of `benchmark/configs/`)."""
    m = cfg['model']
    es = m['embeddings_and_seqformer']
    sf = es['seqformer']
    ie = es['index_embed_size']
    cs = float(es['seq_channel'] + ie)            # 544
    cp = float(es['pair_channel'] + 2 * ie)       # 192
    n1, n2, n3 = float(n), float(n) ** 2, float(n) ** 3
    # Seq attention: per-head q/k/v (cs -> 3 cs) and the gate, the out
    # projection, the pair bias (cp -> heads), QK^T + PV (key dim cs).
    h_seq = sf['seq_attention_with_pair_bias']['num_head']
    seq_attn = (8 * n1 * cs ** 2 + 2 * n1 * cs ** 2 + 2 * n2 * cp * h_seq
                + 4 * n2 * cs)
    seq_trans = 4 * n1 * cs * cs * sf['seq_transition'][
        'num_intermediate_factor']
    noc = float(sf['outer_product_mean']['num_outer_channel'])
    opm = 4 * n1 * cs * noc + 2 * n2 * 2 * noc * cp
    tri_mult = 0.0
    for k in ('triangle_multiplication_outgoing',
              'triangle_multiplication_incoming'):
        nc = float(sf[k]['num_intermediate_channel'])
        # left/right projections and gates (cp -> nc), the final gate
        # (cp -> cp; bench.py counted it at nc), the contraction, the out
        # projection (nc -> cp).
        tri_mult += (2 * n2 * cp * (4 * nc + cp) + 2 * n3 * nc
                     + 2 * n2 * nc * cp)
    tri_attn = 0.0
    for k in ('triangle_attention_starting_node',
              'triangle_attention_ending_node'):
        # Key dim = cp (heads x cp / heads); bench.py had 4 x 32 = 128.
        tri_attn += (tri_attention_core_flops(1, n, int(cp))
                     + 2 * n2 * cp * sf[k]['num_head'])
    pair_trans = 4 * n2 * cp * cp * sf['pair_transition'][
        'num_intermediate_factor']
    trunk = es['seqformer_num_block'] * (seq_attn + seq_trans + opm
                                         + tri_mult + tri_attn + pair_trans)
    dm = m['heads']['diffusion_module']
    ipa_c = dm['IPA']
    nc_ipa, ec = float(ipa_c['num_channel']), float(dm['edge_embed_size'])
    h = ipa_c['num_head']
    nsq, npq = ipa_c['num_scalar_qk'], ipa_c['num_point_qk']
    nsv, npv = ipa_c['num_scalar_v'], ipa_c['num_point_v']
    proj_out = h * nsq + h * (nsv + nsq) + 3 * h * npq + 3 * h * (npv + npq)
    final_in = h * nsv + 3 * h * npv + h * npv + h * ec
    ipa_layer = (2 * n1 * nc_ipa * proj_out          # q/kv scalar + points
                 + 2 * n2 * h * nsq                  # scalar logits
                 + 2 * n2 * h * npq * 3              # point cross terms
                 + 2 * n2 * h * (nsv + 3 * npv + ec)  # the three attends
                 + 2 * n1 * final_in * nc_ipa        # output projection
                 + 2 * n1 * nc_ipa * nc_ipa * ipa_c['num_layer_in_transition']
                 + 2 * n1 * nc_ipa * 6)              # affine update
    # Around the IPA layers (bench.py had a distogram term here, which a
    # design step never runs): the seq / pair input projections, the
    # layer-invariant pair bias, proj_seq, the torsion ResNet and the
    # sequence and pLDDT heads.
    tc = float(ipa_c['torsion']['num_channel'])
    hc_seq = m['heads']['sequence_module']['num_hidden_channel']
    hc_pl = m['heads']['predicted_lddt']['num_hidden_channel']
    around = (2 * n1 * cs * nc_ipa + 2 * n2 * cp * ec + 2 * n2 * ec * h
              + 2 * n1 * nc_ipa * nc_ipa
              + 2 * n1 * (2 * nc_ipa * tc + 4 * tc * tc + tc * 14)
              + 2 * n1 * (nc_ipa * hc_seq + hc_seq * hc_seq + hc_seq * 20)
              + 2 * n1 * (nc_ipa * hc_pl + hc_pl * hc_pl + hc_pl * 50))
    structure = ipa_c['num_layer'] * ipa_layer + around
    esm_proj = 0.0
    if es['esm']['enabled']:
        d = float(es['esm']['embed_channel'])
        l_ab = float(cfg['data']['max_antibody_len'])
        sc = float(es['seq_channel'])
        esm_proj = 2 * l_ab * d * sc + 2 * l_ab * sc * sc
    return trunk + structure + esm_proj


def esm_pass_flops(cfg: Dict) -> float:
    """Products of one ESM2 forward of one sample: per layer the four
    attention projections, QK^T + PV and the FFN (dim -> 4 dim -> dim), at
    the antibody plus linker length (no LM head: the trunk reads the
    layer-weighted representations)."""
    es = _cfg(cfg, 'model', 'embeddings_and_seqformer', 'esm')
    if not es['enabled']:
        return 0.0
    d = float(es['embed_channel'])
    ne = float(cfg['data']['max_antibody_len']
               + es['esm_embed']['sep_pad_num'] + 2)
    layer = esm_self_attention_flops(1, int(ne), int(d)) + 16 * ne * d * d
    return es['num_layers'] * layer


def flops_per_step(cfg: Dict, batch: int, n: int) -> float:
    """Products of one reverse step at `batch` samples of n residues: the
    configuration's num_recycle + 1 trunk passes, each with its ESM2
    forward when ESM2 is on."""
    passes = cfg['model']['num_recycle'] + 1
    return batch * passes * (trunk_pass_flops(cfg, n) + esm_pass_flops(cfg))
