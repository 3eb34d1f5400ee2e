"""Parallelism over processes: a 1-D data mesh (`mesh.py`) and tensor-parallel ESM2 (`esm_tp.py`)."""
