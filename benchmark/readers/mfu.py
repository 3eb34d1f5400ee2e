"""mfu: the products of the window's completed steps (the configuration's
trunk passes and ESM2 forwards, `benchmark/yardstick.flops_per_step`)
over the window's wall time, as a share of the H100's dense bf16 peak,
in %."""

from benchmark import yardstick


def read(ctx):
    if not ctx.window_steps or not ctx.window_wall_s or not ctx.busy_s:
        return None
    flops = ctx.flops_per_step * ctx.window_steps
    return 100.0 * flops / ctx.window_wall_s / yardstick.PEAK_BF16_FLOPS
