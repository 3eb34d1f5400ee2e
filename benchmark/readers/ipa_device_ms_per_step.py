"""ipa_device_ms_per_step: device time of the operations launched inside
the structure-module span (`bench.ipa`, a hook on `IpaScore`) per step,
in ms."""


def read(ctx):
    s = ctx.device_s_in.get('bench.ipa')
    if not ctx.steps or not s:
        return None
    return s * 1e3 / ctx.steps
