"""Device milliseconds a training step of the gradients' all-reduce,
where it does not wait: for each NCCL kernel of the traced steps (the
same collective on every rank, in order), the least time any rank's
kernel took, summed over the stretch and over its steps. The rank that
reaches a collective last barely waits in it, so this is the exchange
itself; a rank's own NCCL time holds its wait for the slower ranks."""


def read(ctx):
    traces = [t for t in ctx.get("rank_traces") or [] if t is not None]
    if not traces or traces[0]["traced_steps"] <= 0:
        return None
    each = [t["nccl_each_s"] for t in traces]
    n = min(len(e) for e in each)
    if n == 0:
        return None
    least = sum(min(e[i] for e in each) for i in range(n))
    return 1e3 * least / traces[0]["traced_steps"]
