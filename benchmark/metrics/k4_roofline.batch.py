"""K4's share of its roofline over the traced stretch: the least time
the paged decode of every decode token the client saw there needs
(each token's cursor, prompt length + index - 1, in every layer; the
benchmark's copy of `paged_work`) over the device time of K4's split
and combine kernels there."""

from harness import roofline
from harness.readings import roofline_share


def read(ctx):
    traced = ctx.get("traced")
    if traced is None or not traced["decode_cursors"]:
        return None
    dm, serve = ctx["dims"], ctx["serving"]
    ps = int(serve["page_size"])
    width = -(-dm["max_len"] // ps)
    nbytes, ops = roofline.paged_work(
        traced["decode_cursors"], dm["n_heads"],
        dm["d_model"] // dm["n_heads"], ps, width, ctx["dtype"])
    layers = dm["n_layers"]
    return roofline_share(ctx["trace"], (nbytes * layers, ops * layers),
                          ("paged_decode",), ctx["dtype"])
