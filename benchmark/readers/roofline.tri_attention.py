"""roofline.tri_attention: the least time the card needs for the traced
`TriangleAttention` calls (the larger of their products at the bf16 peak
and their distinct bytes at the HBM bandwidth, from each call's shape by
`benchmark/yardstick.py`), over the device time launched inside their
spans, in %."""

from benchmark import yardstick


def read(ctx):
    s = ctx.device_s_in.get('bench.tri_attention')
    calls = ctx.calls.get('bench.tri_attention')
    if not s or not calls:
        return None
    bound = 0.0
    for shape, heads in calls:
        b, n, _, c = shape
        bound += yardstick.bound_ms(
            yardstick.tri_attention_flops(b, n, c, heads),
            yardstick.tri_attention_bytes(b, n, c, heads))[0]
    return 100.0 * bound * 1e-3 / s
