"""esm_device_ms_per_step: device time of the operations launched inside
the ESM2 span (`bench.esm`, a hook on the program's ESM2 module) per
step, in ms."""


def read(ctx):
    s = ctx.device_s_in.get('bench.esm')
    if not ctx.steps or not s:
        return None
    return s * 1e3 / ctx.steps
