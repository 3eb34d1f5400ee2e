"""trunk_device_ms_per_step: device time of the operations launched
inside the trunk span (`bench.trunk`, a hook on `EmbeddingAndSeqformer`),
less those inside its ESM2 child span, per step, in ms."""


def read(ctx):
    s = ctx.device_s_in.get('bench.trunk')
    if not ctx.steps or not s:
        return None
    return (s - ctx.device_s_in.get('bench.esm', 0.0)) * 1e3 / ctx.steps
