"""Per-module cache of weights packed for a kernel.

A kernel wrapper that takes its weights in a layout of its own (the fused
[q | k | v | gate] projection of the triangle attention, the packed
[64 values | 64 gates] chunks of tri_mult_pre, their f32 biases and
LayerNorm params) would otherwise build that layout on every call: a dozen
small launches a call on the card.  A module keeps one `WeightCache` per
packed layout and asks it for the packed tensors on each call; they are
rebuilt only when a source parameter was replaced (the weight bridge
loads with `assign=True`), changed in place (its `_version` moves), or
moved, or when another dtype is asked for.
"""

from __future__ import annotations

import weakref

import torch


class WeightCache:
    """Holds what `build()` made from `sources` until one of them changes."""

    def __init__(self):
        self._key = None
        self._value = None
        self.builds = 0

    def get(self, sources, dtype, build):
        """The value `build()` made from `sources` (tensors) for `dtype`,
        made anew when any source is another tensor, lies elsewhere or was
        written since."""
        if not self._valid(sources, dtype):
            with torch.no_grad():
                self._value = build()
            self._key = (dtype, [(weakref.ref(t), t.data_ptr(), t._version)
                                 for t in sources])
            self.builds += 1
        return self._value

    def _valid(self, sources, dtype) -> bool:
        if self._key is None or self._key[0] != dtype:
            return False
        refs = self._key[1]
        return len(refs) == len(sources) and all(
            ref() is t and ptr == t.data_ptr() and ver == t._version
            for (ref, ptr, ver), t in zip(refs, sources))
