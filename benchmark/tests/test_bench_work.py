"""The yardstick's arithmetic against counts made by hand."""

import pytest

from benchmark import work

# d 8, 2 heads of 4, 3 layers, d_ff 32, vocab 10.
CFG = {"hidden_size": 8, "num_attention_heads": 2, "num_hidden_layers": 3,
       "intermediate_size": 32, "vocab_size": 10}


def test_layer_matmul_params_by_hand():
    # wqkv 8x3x2x4 = 192, wo 2x4x8 = 64, w_up and w_down 8x32 each = 512.
    assert work.layer_matmul_params(CFG) == 192 + 64 + 512
    pythia = {"hidden_size": 2048, "num_attention_heads": 16, "intermediate_size": 8192}
    assert work.layer_matmul_params(pythia) == 12 * 2048 * 2048


@pytest.mark.parametrize("seq, window, pairs", [(4, None, 10), (4, 2, 7), (4, 4, 10),
                                                (1, None, 1), (5, 1, 5)])
def test_causal_pairs_by_hand(seq, window, pairs):
    # (4, 2): rows see 1, 2, 2, 2 keys.
    assert work.causal_pairs(seq, window) == pairs


def test_span_flops_by_hand():
    # Position 2 sees 3 keys: 4 * 3 * 2 heads * 4 = 96 a layer.
    per_layer = 2 * 768 + 96
    assert work.span_flops(CFG, 2, 3, logits=False) == 3 * per_layer
    assert work.span_flops(CFG, 2, 3, logits=True) == 3 * per_layer + 2 * 8 * 10
    assert work.span_flops(CFG, 5, 5, logits=True) == 0


@pytest.mark.parametrize("window", [None, 3])
def test_span_flops_is_the_sum_of_its_tokens(window):
    cfg = {**CFG, "sliding_window": window}
    for start, stop in [(0, 7), (3, 9)]:
        by_token = sum(work.span_flops(cfg, p, p + 1, True) for p in range(start, stop))
        assert work.span_flops(cfg, start, stop, True) == pytest.approx(by_token)


def test_train_step_flops_by_hand():
    # 2 rows of 4 positions: products 2*8*(3*768 + 80) = 38,144; attention
    # 3 layers * 2 rows * 4 * 10 pairs * 2 heads * 4 = 1,920; times three.
    assert work.train_step_flops(CFG, 2, 4) == 3 * (38144 + 1920)


def test_train_step_flops_counts_the_window():
    full = work.train_step_flops(CFG, 1, 6)
    windowed = work.train_step_flops({**CFG, "sliding_window": 2}, 1, 6)
    # Pairs 21 -> 11: 10 fewer, at 4 * 2 heads * 4 a pair, 3 layers, x3.
    assert full - windowed == 3 * 3 * 10 * 4 * 2 * 4


def test_k1_bytes_by_hand():
    # Position 5: 6 keys x (k, v) x 2 heads x 4, q and out 2 x 2 x 4, bf16.
    assert work.k1_bytes(CFG, 5) == 3 * (2 * 6 * 2 * 4 + 2 * 2 * 4) * 2


def test_flash_work_by_hand():
    # Per layer 10 pairs x 2 heads = 20; tensors 1 x 4 x 2 x 4 bf16 = 64 bytes,
    # row statistics 2 x 4 float32 = 32 bytes; three layers.
    fwd, dq, dkv = work.flash_work(CFG, 1, 4)
    assert fwd == (3 * 4 * 4 * 20, 3 * (4 * 64 + 32))
    assert dq == (3 * 6 * 4 * 20, 3 * (5 * 64 + 64))
    assert dkv == (3 * 8 * 4 * 20, 3 * (6 * 64 + 64))
    assert work.flash_work(CFG, 1, 4, forwards=2)[0] == (2 * fwd[0], 2 * fwd[1])


def test_roofline_share_takes_the_larger_bound():
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 3.35e12 / 2) == pytest.approx(1.0)
    assert work.roofline_share(1.0, 2.0) == pytest.approx(50.0)
    assert work.roofline_share(1.0, 0.0) is None
