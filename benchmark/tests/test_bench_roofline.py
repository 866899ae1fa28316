"""The yardstick's arithmetic against hand-worked shapes."""

import pytest

from harness import roofline


def test_paged_work_is_additive_over_rows():
    one = roofline.paged_work([5], heads=2, hd=4, ps=4, width=8)
    two = roofline.paged_work([17], heads=2, hd=4, ps=4, width=8)
    both = roofline.paged_work([5, 17], heads=2, hd=4, ps=4, width=8)
    assert both == (one[0] + two[0], one[1] + two[1])
    # cursor 5 reaches pages 0 and 1 (positions 0..5): 2 pages of K and V
    assert one[0] == 2 * 2 * 2 * 4 * 4 * 2 + 2 * 2 * 4 * 2 + 9 * 4
    assert one[1] == 4 * 4 * 2 * 6


def test_bound_names_the_binding_resource():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound_s(1.0, 989e12)
    assert t == pytest.approx(1.0) and by == "operations"


def test_lm_forward_flops_prefill_and_decode():
    cfg = {"vocab_size": 10, "d_model": 4, "n_heads": 2, "n_layers": 1,
           "d_ff": 8}
    per_tok = 2 * (4 * 16 + 2 * 4 * 8)
    head = 2 * 4 * 10
    attn = 4 * 2 * 2
    got = roofline.lm_forward_flops(cfg, prompt_tokens=3, prompt_pairs=6,
                                    head_rows=1, decode_contexts=[4, 5])
    assert got == per_tok * 5 + head * 3 + attn * (6 + 9)


def test_causal_pairs():
    assert [roofline.causal_pairs(t) for t in (1, 2, 4)] == [1, 3, 10]


def test_mlp_train_step_flops_config1():
    w = 784 * 2048 + 2048 * 1024 + 1024 * 10
    assert roofline.mlp_train_step_flops([784, 2048, 1024, 10], 16384) == \
        6.0 * w * 16384
