"""Per cent of the traced stretch in which the card ran none of the
layers' work, averaged over the ranks: no operation ran, or only NCCL's
all-reduce, whose kernel spins while it waits for the other ranks (its
own time is `allreduce_ms.dp4`)."""


def read(ctx):
    traces = [t for t in ctx.get("rank_traces") or [] if t is not None]
    if not traces or any(t["window_s"] <= 0 for t in traces):
        return None
    if all(t["busy_layers_s"] <= 0 for t in traces):
        return None
    share = sum(t["busy_layers_s"] / t["window_s"] for t in traces)
    return 100.0 * (1.0 - share / len(traces))
