"""A tiny cell for the CPU tests: the released configuration's topology at
small widths (and a 2-layer, 64-wide ESM2), the benchmark's complex cut
to 128 antibody residues (the heavy chain and its H3 whole, the light
chain's first 15) and its antigen, B = 2, a few steps."""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from benchmark import manifest

HERE = os.path.dirname(os.path.abspath(__file__))
AB_LEN = 128


def tiny_config(esm: bool = True) -> dict:
    with open(os.path.join(manifest.HERE, 'configs', 'abx_esm2_3b.json'),
              encoding='utf-8') as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg['data']['max_antibody_len'] = AB_LEN
    es = cfg['model']['embeddings_and_seqformer']
    es.update(seq_channel=32, pair_channel=16, index_embed_size=8)
    es['esm'].update(enabled=esm, embed_channel=64, num_layers=2,
                     num_heads=4)
    es['esm']['esm_embed']['repr_layer'] = [0, 1, 2]
    sf = es['seqformer']
    sf['seq_attention_with_pair_bias']['num_head'] = 4
    sf['outer_product_mean']['num_outer_channel'] = 8
    for k in ('triangle_multiplication_outgoing',
              'triangle_multiplication_incoming'):
        sf[k]['num_intermediate_channel'] = 16
    dm = cfg['model']['heads']['diffusion_module']
    dm['edge_embed_size'] = 16
    dm['IPA'].update(num_channel=32, num_head=4, num_layer=2,
                     num_scalar_qk=4, num_scalar_v=4, num_point_qk=2,
                     num_point_v=2)
    dm['IPA']['torsion']['num_channel'] = 16
    for k in ('sequence_module', 'predicted_lddt'):
        cfg['model']['heads'][k].update(num_channel=32,
                                        num_hidden_channel=16)
    return cfg


def tiny_inputs(path: str) -> None:
    """The benchmark's complex cut to AB_LEN antibody residues."""
    with np.load(os.path.join(manifest.HERE, 'inputs',
                              '6ct7_H_L_S.npz')) as z:
        a = {k: np.asarray(z[k]) for k in z.files}
    full_ab = a['anchor_flag'].shape[0]
    keep = np.r_[0:AB_LEN, full_ab:a['seq'].shape[0]]
    out = {}
    for k, v in a.items():
        if k == 'anchor_flag':
            out[k] = v[:AB_LEN]
        elif v.ndim and v.shape[0] == a['seq'].shape[0]:
            out[k] = v[keep]
        else:
            out[k] = v
    out['light_len'] = np.asarray(AB_LEN - int(a['heavy_len']),
                                  a['light_len'].dtype)
    np.savez(path, **out)


def tiny_cell(tmp_path, esm: bool = True, limits=None,
              seconds_steps: int = 4) -> manifest.Cell:
    cfg_path = os.path.join(str(tmp_path), 'tiny.json')
    with open(cfg_path, 'w', encoding='utf-8') as f:
        json.dump(tiny_config(esm), f)
    inputs = os.path.join(str(tmp_path), 'tiny.npz')
    tiny_inputs(inputs)
    traffic = {'inputs': inputs, 'generate_area': 'H3', 'batch': 2,
               'num_t': 4, 'warmup_steps': 2, 'check_steps': 2,
               'check_from': 1, 'check_below': 4, 'trace_from': 1,
               'trace_steps': 2}
    lim = limits or {'start': 0.0, 'esm': 0.1, 'logits': 0.1,
                     'frames': 0.1, 'update': 0.0}
    if not esm:
        lim = {k: v for k, v in lim.items() if k != 'esm'}
    return manifest.Cell(
        name='tiny', config_name='tiny', config_path=cfg_path,
        traffic_name='tiny', traffic=traffic, chips=1,
        end_to_end=[{'name': n, 'unit': u} for n, u in
                    (('designs_per_hour', 'samples/h'),
                     ('step_ms_p90', 'ms'), ('peak_mem_gib', 'GiB'),
                     ('setup_s', 's'))],
        per_layer=[{'name': n, 'unit': '%'} for n in
                   ('launches_per_step', 'idle_share', 'mfu')],
        limits=lim)
