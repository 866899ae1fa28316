"""The data-parallel step's share of the chips' bf16 peak over the
window: model FLOPs of every global step (6 per weight and example)
over the window's seconds, the chips and 989 TFLOP/s each."""

from harness import roofline


def read(ctx):
    if ctx["steps"] <= 0:
        return None
    flops = ctx["steps"] * roofline.mlp_train_step_flops(ctx["sizes"],
                                                         ctx["rows"])
    peak = roofline.PEAK_OPS_PER_S[ctx["dtype"]] * ctx["chips"]
    return 100.0 * flops / ctx["window_s"] / peak
