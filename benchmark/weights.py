"""Random weights made from the run's seed, on the device, in the type the
program keeps them in, by one random draw per group of parameters.

Both sides of the correctness check get the same values: the program
through its own weight-loading path, the reference by drawing them again
from the same seed once the program is gone.

The recipe, by parameter name and shape (no parameter is left at zero,
so that every layer carries signal into the comparison):
- a 2-D weight (out, in): N(0, 1/in), so each output has unit scale;
  the structure module's `affine_update` at a tenth of that, so that a
  layer's frame update stays a small rotation and a step of about 1 A;
- an embedding table (`embedding`, `embed_tokens.weight`): N(0, 1);
- a 1-D `weight` or `scale` (a LayerNorm gain): 1 + 0.1 N(0, 1);
- any other 1-D parameter (biases, layer weights, point weights): 0.1 N(0, 1).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def _scale(name: str, shape) -> Tuple[float, float]:
    """(std, mean) of the parameter `name`."""
    leaf = name.rsplit('.', 1)[-1]
    if name.endswith('embed_tokens.weight') or leaf == 'embedding':
        return 1.0, 0.0
    if len(shape) == 2:
        std = float(shape[1]) ** -0.5
        return (0.1 * std if 'affine_update' in name else std), 0.0
    if leaf in ('weight', 'scale'):
        return 0.1, 1.0
    return 0.1, 0.0


def spec_of(module: torch.nn.Module) -> Spec:
    """(name, shape) of every parameter of `module`, in its order."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def make(spec: Spec, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `spec`: views into one buffer drawn from
    N(0, 1) by one generator on `device` seeded with `seed`, laid out in
    the order of the names (so the values do not depend on the order in
    which a module registers its parameters), each scaled in place by its
    rule."""
    spec = sorted(spec)
    total = sum(_numel(s) for _, s in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    out, i = {}, 0
    with torch.no_grad():
        for name, shape in spec:
            n = _numel(shape)
            t = flat[i:i + n].view(shape)
            std, mean = _scale(name, shape)
            t.mul_(std)
            if mean:
                t.add_(mean)
            out[name] = t
            i += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def seeds(seed: int) -> Dict[str, int]:
    """The generator seeds a run derives from its `--seed`: the trunk's
    and ESM2's weights, and the warm-up trajectory.  Trajectory k of the
    window is seeded with seed + k."""
    base = (int(seed) * 8) % (2 ** 62)
    return {'trunk': base + 1, 'esm': base + 2, 'warmup': base + 3}
