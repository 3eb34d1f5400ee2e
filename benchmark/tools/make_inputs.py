"""Write a complex's raw input features as the benchmark's input file.

    python -m benchmark.tools.make_inputs testdata/6ct7_H_L_S.pdb \
        benchmark/inputs/6ct7_H_L_S.npz

The file holds the per-complex feature arrays that the design CLI hands
to the sampler after parsing the PDB (`cli/runner.load_complexes`): the
sequence, masks, atom14 coordinates, CDR and chain ids, residue indices,
anchor flags and chain lengths.  The benchmark reads this file on both
sides, the program's and the reference's, so neither parses the PDB in a
run.  Only this tool imports the port's data loader; the benchmark's runs
never call it.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None):
    from abx_tpu_torch.data import dataset as ds
    from abx_tpu_torch.data.dataset import DataConfig
    pdb, out = (argv or sys.argv[1:])[:2]
    name = os.path.splitext(os.path.basename(pdb))[0]
    parts = name.split('_')
    ex = ds.complex_from_pdb(pdb, parts[1], parts[2], parts[3].split('|'))
    feats, _ = ds.prepare_example(ex, DataConfig(256, 32, 16.0, 5, False),
                                  False)
    np.savez_compressed(out, **{k: np.asarray(v) for k, v in feats.items()})


if __name__ == '__main__':
    main()
