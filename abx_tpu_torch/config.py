"""Model / diffuser / data configuration as plain nested dicts.

Counterpart of `abx_tpu/config.py` without ml_collections: the same
defaults, the same `config/*.json` layout merged over them, and the same
tiny test configuration.  `Cfg` gives attribute access so model code reads
`cfg.model.num_recycle` exactly as the JAX package does.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Optional


class Cfg(dict):
    """A dict with attribute access; nested dicts become `Cfg` too."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, Cfg):
                self[k] = Cfg(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = Cfg(value) if isinstance(value, dict) else value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Cfg) else copy.deepcopy(v)
                for k, v in self.items()}


def _merge(base: dict, over: dict) -> dict:
    """Recursive update, as ml_collections.ConfigDict.update does."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def model_config() -> Cfg:
    """Default model configuration (== reference config_model.json values)."""
    seqformer_block = {
        'seq_attention_with_pair_bias': {
            'orientation': 'per_row', 'num_head': 32,
            'dropout_rate': 0.1, 'shared_dropout': True},
        'seq_transition': {
            'orientation': 'per_row', 'num_intermediate_factor': 4,
            'dropout_rate': 0.0, 'shared_dropout': True},
        'outer_product_mean': {
            'orientation': 'per_row', 'num_outer_channel': 64,
            'dropout_rate': 0.0, 'shared_dropout': True},
        'triangle_multiplication_outgoing': {
            'orientation': 'per_row', 'num_intermediate_channel': 128,
            'gating': True, 'dropout_rate': 0.1, 'shared_dropout': False},
        'triangle_multiplication_incoming': {
            'orientation': 'per_column', 'num_intermediate_channel': 128,
            'gating': True, 'dropout_rate': 0.1, 'shared_dropout': False},
        'triangle_attention_starting_node': {
            'orientation': 'per_row', 'num_head': 4, 'gating': True,
            'dropout_rate': 0.1, 'shared_dropout': False},
        'triangle_attention_ending_node': {
            'orientation': 'per_column', 'num_head': 4, 'gating': True,
            'dropout_rate': 0.1, 'shared_dropout': False},
        'pair_transition': {
            'orientation': 'per_row', 'num_intermediate_factor': 4,
            'dropout_rate': 0.0, 'shared_dropout': True},
    }
    cfg = {
        'model': {
            'num_atom': 5,
            'num_recycle': 2,
            'embeddings_and_seqformer': {
                'seqformer_num_block': 1,
                'seq_channel': 512,
                'pair_channel': 128,
                'max_relative_feature': 32,
                'index_embed_size': 32,
                'esm': {
                    'enabled': False,
                    'embed_channel': 2560,
                    'num_layers': 36,
                    'dropout_rate': 0.1,
                    'norm': True,
                    'esm_embed': {
                        'return_attnw': False,
                        'sep_pad_num': 48,
                        'repr_layer': list(range(37)),
                        'model_path': './trained_model/esm2_t36_3B_UR50D.pt',
                    },
                },
                'recycle_features': True,
                'recycle_pos': True,
                'prev_pos': {
                    'min_bin': 3.375, 'num_bins': 15, 'max_bin': 21.375},
                'seqformer': seqformer_block,
            },
            'heads': {
                'diffusion_module': {
                    'coordinate_scaling': 0.1,
                    'num_blocks': 4,
                    'node_embed_size': 256,
                    'edge_embed_size': 128,
                    'embed': {
                        'index_embed_size': 32,
                        'num_bins': 22,
                        'min_bin': 1e-5,
                        'max_bin': 20.0,
                        'embed_self_conditioning': True,
                    },
                    'IPA': {
                        'num_layer': 8,
                        'position_scale': 10,
                        'torsion': {
                            'num_residual_block': 2,
                            'atom_clamp_distance': 10,
                            'num_channel': 128,
                        },
                        'num_layer_in_transition': 3,
                        'clash_overlap_tolerance': 1.5,
                        'num_head': 12,
                        'num_channel': 256,
                        'num_scalar_qk': 16,
                        'num_scalar_v': 16,
                        'num_point_qk': 4,
                        'num_point_v': 8,
                        'dropout': 0.1,
                    },
                },
                'predicted_lddt': {
                    'num_channel': 256, 'num_hidden_channel': 128,
                    'index_embed_size': 32},
                'sequence_module': {
                    'num_channel': 256, 'num_hidden_channel': 128,
                    'index_embed_size': 32},
                'distogram': {
                    'first_break': 2.3125, 'last_break': 21.6875,
                    'num_bins': 64, 'index_embed_size': 32},
                'tmscore': {'num_atom': 5},
                'metric': {},
            },
        },
        'loss': {
            'diffusion_rigids': {
                'enabled': True,
                'config': {
                    'coordinate_scaling': 0.1,
                    'trans_loss_weight': 1.0,
                    'rot_loss_weight': 0.5,
                    'rot_loss_t_threshold': 0.2,
                    'separate_rot_loss': True,
                    'trans_x0_t_threshold': 1.0,
                },
                'weight': 1.0,
            },
            'diffusion_seq': {
                'enabled': True,
                # exact_elbo: the exact tau-leaping CTMC ELBO
                # (train/losses.py ctmc_elbo_terms) in place of the
                # surrogate CE.
                'config': {'ratio_eps': 1e-9, 'nll_weight': 1,
                           'exact_elbo': False},
                'weight': 0.2,
            },
            'folding': {
                'enabled': True,
                'config': {
                    't_filter': 0.25,
                    'backbone_fape_weight': 0.5,
                    'fape': {
                        'weight': 1.0, 'fape_min': 1e-6,
                        'loss_unit_distance': 10.0, 'clamp_distance': 10.0,
                        'unclamped_ratio': 0.1},
                    'interface_fape': {
                        'interface_weight': 0.5,
                        'loss_unit_distance': 20.0, 'clamp_distance': 30.0},
                    'violation_tolerance_factor': 12,
                    'structural_violation_loss_weight': 0.03,
                    'clash_overlap_tolerance': 1.5,
                    'between_chain_factor': 0.2,
                    'average_clashes': True,
                },
                'weight': 1.0,
            },
            'distogram': {
                'enabled': True, 'config': {'t_filter': 0.25}, 'weight': 0.5},
            'predicted_lddt': {
                'enabled': True, 'config': {'t_filter': 0.25}, 'weight': 0.1},
        },
        'diffuser': {
            'inference_step': 100,
            'diffuse': {
                'diffuse_trans': True, 'diffuse_rot': True,
                'diffuse_seq': True},
            'r3': {'min_b': 0.1, 'max_b': 20.0, 'coordinate_scaling': 0.1},
            'so3': {
                'num_omega': 1000, 'num_sigma': 1000, 'min_sigma': 0.1,
                'max_sigma': 1.5, 'schedule': 'logarithmic',
                'cache_dir': '.cache/', 'use_cached_score': True},
            'seq': {'rate_const': 0.3},
        },
        'data': {
            'max_antibody_len': 256,
            'max_antigen_len': 32,
            'patch_radius': 16.0,
            'anchor_neighbors': 5,
            'parity_random_antigen_window': False,
        },
    }
    return Cfg(cfg)


def load_config(path: Optional[str] = None) -> Cfg:
    """Load a JSON config file (reference config_model.json layout) merged
    over the defaults."""
    cfg = model_config().to_dict()
    if path:
        with open(path, 'r', encoding='utf-8') as f:
            _merge(cfg, json.load(f))
    return Cfg(cfg)


def tiny_model_config() -> Cfg:
    """Scaled-down config for tests: same topology, small channels."""
    cfg = model_config()
    es = cfg.model.embeddings_and_seqformer
    es.seq_channel = 32
    es.pair_channel = 16
    es.index_embed_size = 8
    sf = es.seqformer
    sf.seq_attention_with_pair_bias.num_head = 4
    sf.outer_product_mean.num_outer_channel = 8
    sf.triangle_multiplication_outgoing.num_intermediate_channel = 8
    sf.triangle_multiplication_incoming.num_intermediate_channel = 8
    sf.triangle_attention_starting_node.num_head = 2
    sf.triangle_attention_ending_node.num_head = 2
    heads = cfg.model.heads
    ipa = heads.diffusion_module.IPA
    ipa.num_layer = 2
    ipa.num_channel = 32
    ipa.num_head = 4
    ipa.num_scalar_qk = 4
    ipa.num_scalar_v = 4
    ipa.num_point_qk = 2
    ipa.num_point_v = 2
    ipa.torsion.num_channel = 16
    heads.predicted_lddt.num_channel = 32
    heads.predicted_lddt.num_hidden_channel = 16
    heads.sequence_module.num_channel = 32
    heads.sequence_module.num_hidden_channel = 16
    cfg.model.num_recycle = 1
    cfg.diffuser.so3.num_omega = 200
    cfg.diffuser.so3.num_sigma = 100
    cfg.data.max_antibody_len = 48
    cfg.data.max_antigen_len = 8
    return cfg
