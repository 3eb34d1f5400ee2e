"""Build and load the package's CUDA kernels (`abx_tpu_torch/csrc/*.cu`).

The sources are compiled with `nvcc` for sm_90a, one process per `.cu`
file, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes.  The build happens at first use,
into `build/abx_tpu_torch/<hash>/` at the repository root, keyed on a hash
of the sources and flags, so a second process reuses it.  Nothing is built
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'abx_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'abx_row_linear': [_I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _I, _I, _P],
    'abx_tri_mult_pre': [_I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                         _I, _P, _P, _P],
    'abx_tri_mult_post_c_major': [_I, _P, _I, _I] + [_P] * 7 + [_I] * 3
                                 + [_P],
    'abx_tri_mult_post_c_major_sm90': [_P, _I, _I, _I, _I] + [_P] * 8,
    'abx_recycle_embed': [_I, _P, _P, _I, _I] + [_P] * 6 + [_I] * 5 + [_P],
    'abx_fused_transition': [_I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P],
    'abx_fused_transition_sm90': [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _P],
    'abx_pair_bias_proj': [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    'abx_tri_attention_core': [_I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                               _I, _I, _P, _P],
    'abx_triangle_attention_fused': [_I] + [_P] * 6 + [_I] * 5 + [_P],
    'abx_ipa_attention': [_I] + ([_P] + [_I] * 3) * 6 + [_P, _P] + [_I] * 5
                         + [_P] * 5 + [_I] * 7 + [_P],
    'abx_esm_attention': [_I] + [_P] * 6 + [_I] * 4 + [_P],
    'abx_esm_flash_attention': [_I] + [_P] * 6 + [_I] * 4 + [_P],
    'abx_esm_flash_sm90_info': [_I, _I, _P],
    'abx_gate_proj': [_I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    'abx_tri_mult_post_gatefold': [_I, _P, _P, _I, _I, _I] + [_P] * 10,
    'abx_tri_mult_post_gatefold_sm90': [_P, _P, _I, _I, _I] + [_P] * 10,
    'abx_ipa_pair_attend': [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    'abx_triangle_multiply': [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'abx_esm_layer_norm': [_I, _P, _P, _P, _P, _I, _I, _F, _P],
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob('*.cu')), sorted(CSRC.glob('*.cuh'))


def source_hash() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of abx_tpu_torch '
                           'are built with the CUDA toolkit at first use')
    return path


def _run_all(cmds, logs):
    """Run the commands together, each writing its output to its log;
    return their exit codes."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, 'w') as f:
            f.write(' '.join(cmd) + '\n')
            f.flush()
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    return [p.wait() for p in procs]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library path.  The compilers' output (with -Xptxas -v register and
    spill counts) is kept beside it as build.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / 'libabx_kernels.so'
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    cu, _ = _sources()
    objs = [out_dir / f'{src.stem}.{tag}.o' for src in cu]
    logs = [out_dir / f'{src.stem}.{tag}.log' for src in cu]
    codes = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(src)]
                      for src, o in zip(cu, objs)], logs)
    tmp = out_dir / f'libabx_kernels.{tag}.tmp.so'
    if not any(codes):
        logs.append(out_dir / f'link.{tag}.log')
        codes += _run_all([[nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                            *map(str, objs)]], logs[-1:])
    texts = [log.read_text() for log in logs]
    (out_dir / 'build.log').write_text(''.join(texts))
    for path in objs + logs:
        path.unlink(missing_ok=True)
    if any(codes):
        failed = ''.join(t for t, c in zip(texts, codes) if c)
        raise RuntimeError(f'nvcc failed (exit codes {codes}):\n'
                           f'{failed[:8000]}')
    os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:  # the wrappers' fast path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def ptr(t):
    """Device pointer of a tensor (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of t's device (without
    building a torch.cuda.Stream: the wrappers' host time counts on the
    host-bound ESM pass)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')


def refuse_autograd(name: str, *tensors) -> None:
    """A hand-written kernel has no backward: launched on an input that
    requires grad, with grad enabled, it would return a result that stops
    the gradient without a word.  The wrappers call this before a launch
    and raise instead (they never fall back to the plain version); the
    models take no kernel route in train() mode."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name}: the hand-written kernel has no backward, and an input '
            'requires grad; run it under torch.no_grad() or take the plain '
            'route (a model in train() mode takes no kernel route)')


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda_inputs(name: str, dtype, f32=None, i64=None,
                      **tensors) -> None:
    """Device / dtype / contiguity checks shared by the kernel wrappers.

    Every tensor must be a contiguous CUDA tensor.  Those passed by keyword
    must be in the compute dtype `dtype`; those in the dicts `f32` and
    `i64` in float32 and int64.  None stands for an absent operand."""
    require(dtype in DTYPE_CODE, f'{name}: dtype {dtype} not supported')
    for group, want in ((tensors, dtype), (f32 or {}, torch.float32),
                        (i64 or {}, torch.int64)):
        for key, t in group.items():
            if t is None:
                continue
            require(t.is_cuda, f'{name}: {key} is not on a CUDA device')
            require(t.is_contiguous(), f'{name}: {key} is not contiguous')
            require(t.dtype == want,
                    f'{name}: {key} is {t.dtype}, expected {want}')
