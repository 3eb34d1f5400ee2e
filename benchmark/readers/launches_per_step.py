"""launches_per_step: kernel-launch API calls in the traced stretch per
step (sampler loop, host).  A count that repeats exactly."""


def read(ctx):
    if not ctx.steps or not ctx.n_device_events:
        return None
    return ctx.launches / ctx.steps
