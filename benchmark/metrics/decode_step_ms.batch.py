"""Milliseconds of the window per decode step dispatched (the host's
clock over the loop's dispatch count times its horizon)."""

from harness.readings import decode_steps


def read(ctx):
    steps = decode_steps(ctx)
    if steps <= 0:
        return None
    return 1e3 * ctx["window_s"] / steps
