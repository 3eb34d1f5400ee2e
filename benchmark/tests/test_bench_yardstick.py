"""The yardstick's counts pinned against PERF.md's kernel table (B = 4,
the flagship shapes) and against the modules they count."""

import json
import os

import pytest

from benchmark import manifest, yardstick


def _cfg(name):
    with open(os.path.join(manifest.HERE, 'configs', name + '.json'),
              encoding='utf-8') as f:
        return json.load(f)


def test_tri_attention_core_is_kernel_row_1():
    # Row 1: 195.69 GFLOP at (4, 288, 288, 192), H = 4, D = 48.
    assert yardstick.tri_attention_core_flops(4, 288, 192) / 1e9 == \
        pytest.approx(195.69, abs=0.01)


def test_row_1_bytes_count_the_residual_apart():
    # Row 1's 388.3 MB: chip_smoke's case hands the kernel the input and
    # the residual as two bf16 copies, and an f32 bias and f32 weights.
    # In the model the residual is the input, so the module's distinct
    # bytes count it once (`tri_attention_bytes`).
    b, n, c, h = 4, 288, 192, 4
    act = b * n * n * c * 2
    row1 = 3 * act + b * h * n * n * 4 + 5 * c * c * 4 + 6 * c * 4 + b * n * 4
    assert row1 / 1e6 == pytest.approx(388.3, abs=0.1)
    module = yardstick.tri_attention_bytes(b, n, c, h)
    assert module == pytest.approx(2 * act + (2 * c + 5 * c * c + 2 * c
                                              + c * h) * 4 + b * n * 4)


def test_esm_attention_core_is_kernel_row_12():
    # Row 12: 3.84 GFLOP, 25.1 MB at (4, 40, 306, 64).
    assert yardstick.esm_attention_core_flops(4, 40, 306, 64) / 1e9 == \
        pytest.approx(3.84, abs=0.01)
    assert yardstick.esm_attention_core_bytes(4, 40, 306, 64) / 1e6 == \
        pytest.approx(25.1, abs=0.05)


def test_bound_is_the_larger_time():
    ms, by = yardstick.bound_ms(989e9, 0)
    assert ms == pytest.approx(1.0) and by == 'operations'
    ms, by = yardstick.bound_ms(0, 3.35e9)
    assert ms == pytest.approx(1.0) and by == 'bytes'


def test_step_counts_triangle_attention_at_key_dim_192():
    cfg = _cfg('abx_no_esm')
    n, cp = 288, 192
    per_orientation = (10 * n * n * cp * cp + 4 * n ** 3 * cp
                       + 2 * n * n * cp * 4)
    assert per_orientation / 1e9 == pytest.approx(49.05, abs=0.01)
    # Halving the key dim back to bench.py's 4 x 32 would cut the pass by
    # the difference of the two orientations' counts.
    trunk = yardstick.trunk_pass_flops(cfg, n)
    assert trunk / 1e9 == pytest.approx(232.26, abs=0.01)


def test_step_flops_of_the_cells():
    no_esm = yardstick.flops_per_step(_cfg('abx_no_esm'), 16, 288)
    esm = yardstick.flops_per_step(_cfg('abx_esm2_3b'), 16, 288)
    assert no_esm / 1e12 == pytest.approx(11.148, abs=0.001)
    # ESM2-3B: 36 layers of 24 n d^2 + 4 n^2 d at n = 306, d = 2560, in
    # each of the 3 passes, and the trunk's ESM projection.
    layer = 24 * 306 * 2560 ** 2 + 4 * 306 ** 2 * 2560
    assert yardstick.esm_pass_flops(_cfg('abx_esm2_3b')) == \
        pytest.approx(36 * layer)
    assert esm / 1e12 == pytest.approx(96.012, abs=0.001)


def test_tensor_bytes_counts_a_tensor_once():
    import torch
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    y = torch.zeros(3, dtype=torch.float32)
    assert yardstick.tensor_bytes([x, x, y]) == 4 * 8 * 2 + 3 * 4
