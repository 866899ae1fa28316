"""Helpers the per-layer metric readers (`metrics/*.py`) share. Each
takes the context a runner hands the readers and returns a number, or
None where the run holds nothing to read."""

from __future__ import annotations

from harness import roofline


def decode_steps(ctx) -> int:
    """Decode steps the loop dispatched in the window (dispatches x
    horizon)."""
    d = ctx["snap1"]["dispatches"] - ctx["snap0"]["dispatches"]
    return int(d) * int(ctx["snap1"]["horizon"])


def idle_share(ctx):
    """Per cent of the traced stretch in which no device operation ran
    (busy seconds averaged over the chips used)."""
    t = ctx.get("trace_summary")
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_share(trace, work, needles, dtype="bfloat16"):
    """Per cent of the kernels' device time (events whose name holds a
    needle) that `work` = (bytes, operations) needs at the chip's
    peaks."""
    if trace is None:
        return None
    t = trace.kernel_seconds(*needles)
    if t <= 0:
        return None
    least, _ = roofline.bound_s(*work, dtype)
    return 100.0 * least / t
