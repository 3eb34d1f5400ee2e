"""The plain float32 reference of one design step, which decides `correct`.

Frozen copies of the plain math of the port's model (trunk, ESM2, IPA,
heads), diffusers and feature pipeline, in plain PyTorch and float32 with
TF32 off, with the parameter names of the port's modules.  It imports
nothing of the port and reads nothing the port made: it builds its own
features from the benchmark's input file, its own IGSO(3) tables, and
gets its weights from the benchmark's seed.  `step.Reference` is the entry.
"""
