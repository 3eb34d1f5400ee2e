"""idle_share: 1 - the union of the device operations' intervals over the
traced stretch's wall time, in %."""


def read(ctx):
    if not ctx.window_s or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
