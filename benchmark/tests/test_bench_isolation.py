"""Nothing the benchmark runs imports `jax` or the JAX package (`abx_tpu`),
by whole top-level name, and the reference imports nothing of the port."""

import os
import subprocess
import sys

from benchmark import cell as cell_lib
from benchmark import manifest

ROOT = manifest.ROOT


def _modules_after(code: str):
    """Top-level names of the modules a fresh interpreter holds after
    `code` (JAX and the JAX package blocked from loading by accident)."""
    probe = (code + '\nimport sys\nprint(" ".join(sorted({m.split(".")[0] '
             'for m in sys.modules})))')
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(out.stdout.split())


def test_whole_name_comparison():
    assert 'abx_tpu' in cell_lib.BANNED
    sys.modules.setdefault('abx_tpu_torch_probe_x', sys)
    try:
        names = cell_lib.banned_modules()
        assert 'abx_tpu_torch_probe_x' not in names
        assert not any(n.startswith('abx_tpu_torch') for n in names)
    finally:
        del sys.modules['abx_tpu_torch_probe_x']


def test_reference_imports_nothing_of_the_port():
    mods = _modules_after('import benchmark.reference.step, '
                          'benchmark.check, benchmark.yardstick')
    assert not mods & {'abx_tpu_torch', 'abx_tpu', 'jax', 'jaxlib', 'flax'}


def test_harness_and_program_import_no_jax():
    mods = _modules_after(
        'import benchmark.run, benchmark.cell, benchmark.calibrate\n'
        'from abx_tpu_torch.cli import runner\n'
        'from abx_tpu_torch.sampling import sampler')
    assert 'abx_tpu_torch' in mods
    assert not mods & set(cell_lib.BANNED)


def test_sources_name_no_jax_module():
    bad = []
    for dirpath, _, files in os.walk(manifest.HERE):
        for f in files:
            if not f.endswith('.py') or f.startswith('test_bench_isolation'):
                continue
            with open(os.path.join(dirpath, f), encoding='utf-8') as fh:
                for line in fh:
                    words = line.split()
                    if words[:1] in (['import'], ['from']) and len(words) > 1:
                        top = words[1].split('.')[0].rstrip(',')
                        if top in cell_lib.BANNED:
                            bad.append((f, line.strip()))
    assert not bad
