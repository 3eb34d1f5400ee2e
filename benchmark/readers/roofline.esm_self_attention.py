"""roofline.esm_self_attention: the least time the card needs for the
traced `ESMSelfAttention` calls, projections included (the larger of
their products at the bf16 peak and their distinct bytes at the HBM
bandwidth, from each call's shape by `benchmark/yardstick.py`), over the
device time launched inside their spans, in %."""

from benchmark import yardstick


def read(ctx):
    s = ctx.device_s_in.get('bench.esm_self_attention')
    calls = ctx.calls.get('bench.esm_self_attention')
    if not s or not calls:
        return None
    bound = 0.0
    for shape, _ in calls:
        b, n, d = shape
        bound += yardstick.bound_ms(
            yardstick.esm_self_attention_flops(b, n, d),
            yardstick.esm_self_attention_bytes(b, n, d))[0]
    return 100.0 * bound * 1e-3 / s
