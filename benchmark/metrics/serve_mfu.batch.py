"""The serving step's share of the chip's bf16 peak over the window:
model FLOPs of the prompts prefilled (their first token seen in the
window) and of every decode token seen, 2 per weight a token meets,
the output head once a prompt and once a decode token, and the causal
attention, over the window's seconds and 989 TFLOP/s."""

from harness import roofline


def read(ctx):
    st = ctx["stats"]
    if not st["decode_cursors"]:
        return None
    prompts = st["first_prompts"]
    flops = roofline.lm_forward_flops(
        ctx["dims"], prompt_tokens=sum(prompts),
        prompt_pairs=sum(roofline.causal_pairs(p) for p in prompts),
        head_rows=len(prompts),
        decode_contexts=[c + 1 for c in st["decode_cursors"]])
    peak = roofline.PEAK_OPS_PER_S[ctx["dtype"]]
    return 100.0 * flops / ctx["window_s"] / peak
