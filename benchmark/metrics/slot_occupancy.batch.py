"""Per cent of the decode step's slots that emitted a token: decode
tokens the client saw in the window over (decode steps x slots). The
steps are the loop's counter read at the window's two ends, the tokens
the client's stamps, so the two may differ by the tokens of one step at
each end: a full loop can read a hair over 100."""

from harness.readings import decode_steps


def read(ctx):
    steps = decode_steps(ctx)
    if steps <= 0:
        return None
    tokens = len(ctx["stats"]["decode_cursors"])
    return 100.0 * tokens / (steps * int(ctx["serving"]["slots"]))
