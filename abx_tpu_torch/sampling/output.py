"""Host-side post-processing: sampler outputs -> PDB files.

The port's own copy of `postprocess_sample`, `postprocess_reference` and
`postprocess_trajectory` of `abx_tpu/sampling/output.py` (same names, same
PDB text): designed antibody chains with per-residue pLDDT b-factors, plus
the (cropped) antigen context chains.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from abx_tpu_torch.common import residue_constants as rc
from abx_tpu_torch.data.pdb_io import save_complex_pdb


def postprocess_sample(output_dir: str, meta: Dict, result: Dict,
                       batch_index: int = 0, time_tag: Optional[float] = None):
    """Write one designed complex to `<output_dir>/<name>[@t].pdb`."""
    name = meta['name']
    str_heavy = meta['str_heavy_seq']
    str_light = meta['str_light_seq']
    h_len, l_len = len(str_heavy), len(str_light)

    seq = np.asarray(result['seq'][batch_index])
    atom14 = np.asarray(result['atom14'][batch_index])
    plddt_mean = float(np.asarray(result['plddt'][batch_index]))

    heavy_seq = rc.index_to_sequence(seq[:h_len])
    light_seq = rc.index_to_sequence(seq[h_len:h_len + l_len])

    plddt_res = np.full((h_len + l_len,), plddt_mean)

    antigen_chains = name.split('_')[-1].split('|') if '_' in name else []
    antigen_data = {
        'antigen_str_seq': meta.get('antigen_origin_str_seq', ''),
        'antigen_coords': meta.get('antigen_origin_coords'),
        'antigen_coord_mask': meta.get('antigen_origin_coord_mask'),
        'antigen_chain_ids': meta.get('antigen_origin_chain_ids'),
        'antigen_chains': antigen_chains,
    }

    suffix = f'@{time_tag:.4f}' if time_tag is not None else ''
    pdb_file = os.path.join(output_dir, f'{name}{suffix}.pdb')
    heavy_chain = name.split('_')[1] if name.count('_') >= 2 else 'H'
    light_chain = name.split('_')[2] if name.count('_') >= 2 else 'L'
    save_complex_pdb(pdb_file, heavy_seq, heavy_chain, light_seq, light_chain,
                     atom14[:h_len + l_len], plddt_res, antigen_data)
    return pdb_file


def postprocess_reference(output_dir: str, meta: Dict, feats: Dict,
                          batch_index: int = 0):
    """Write the ground-truth complex (reference/*.pdb, inference.py:355-367).
    """
    name = meta['name']
    str_heavy = meta['str_heavy_seq']
    str_light = meta['str_light_seq']
    h_len, l_len = len(str_heavy), len(str_light)
    atom14 = np.asarray(feats['atom14_gt_positions'][batch_index])
    plddt_res = np.full((h_len + l_len,), 100.0)
    antigen_chains = name.split('_')[-1].split('|') if '_' in name else []
    antigen_data = {
        'antigen_str_seq': meta.get('antigen_origin_str_seq', ''),
        'antigen_coords': meta.get('antigen_origin_coords'),
        'antigen_coord_mask': meta.get('antigen_origin_coord_mask'),
        'antigen_chain_ids': meta.get('antigen_origin_chain_ids'),
        'antigen_chains': antigen_chains,
    }
    pdb_file = os.path.join(output_dir, f'{name}.pdb')
    heavy_chain = name.split('_')[1] if name.count('_') >= 2 else 'H'
    light_chain = name.split('_')[2] if name.count('_') >= 2 else 'L'
    save_complex_pdb(pdb_file, str_heavy, heavy_chain, str_light, light_chain,
                     atom14[:h_len + l_len], plddt_res, antigen_data)
    return pdb_file


def postprocess_trajectory(output_dir: str, meta: Dict, result: Dict,
                           batch_index: int = 0) -> List[str]:
    """Write every step of a collected trajectory (`result['trajectory']`:
    't' (S,), 'seq', 'atom14', 'plddt' with a leading step axis) as
    `<name>@<t>.pdb`."""
    traj = result['trajectory']
    times = np.asarray(traj['t'])
    files = []
    for i in range(times.shape[0]):
        step_result = {
            'seq': traj['seq'][i],
            'atom14': traj['atom14'][i],
            'plddt': traj['plddt'][i],
        }
        files.append(postprocess_sample(
            output_dir, meta, step_result, batch_index,
            time_tag=float(times[i])))
    return files
