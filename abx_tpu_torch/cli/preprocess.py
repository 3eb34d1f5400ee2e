"""Thin shim mirroring the reference's preprocess_data.py entry point
(the port's copy of `abx_tpu/cli/preprocess.py`):

    python -m abx_tpu_torch.cli.preprocess --summary_file sabdab.tsv \\
        --struct_dir structures/ --output_dir npz/ \\
        [--numbering auto|anarci|template|abnum]
"""
from abx_tpu_torch.preprocess.make_data import main

if __name__ == '__main__':
    main()
