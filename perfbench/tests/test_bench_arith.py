"""The benchmark's arithmetic against hand counts at small shapes."""

from perfbench.harness import arith
from perfbench.reference.common import ModelConfig


def test_bytes():
    # 3 x 5 f32 read, 3 f32 weights, 5 f32 written
    assert arith.fedavg_bytes(3, 5) == 60 + 12 + 20
    assert arith.fedavg_bytes(3, 5, size=2) == 30 + 12 + 10


def test_causal_pairs():
    assert [arith.causal_pairs(s) for s in (1, 2, 3, 4)] == [1, 3, 6, 10]


def test_decoder_only_forward():
    # the vlm family's decoder-only LM, no image slots
    cfg = ModelConfig("d", "vlm", n_layers=1, d_model=4, n_heads=2, n_kv_heads=1, d_ff=6,
                      vocab_size=256)
    S, hd = 3, 2
    proj = 2 * 4 * (2 * hd + 2 * 1 * hd) + 2 * 2 * hd * 4       # q, k, v in; o out
    pairs = 2 * 6 * 2 * (hd + hd)                                # 6 causal pairs, 2 heads
    mlp = 3 * 2 * 4 * 6
    head = 2 * S * 4 * 256
    assert arith.forward_flops(cfg, S) == S * proj + pairs + S * mlp + head
    assert arith.train_flops(cfg, S, 5) == 15 * arith.forward_flops(cfg, S)


def test_moe_forward_counts_the_chosen_experts():
    cfg = ModelConfig("m", "moe", n_layers=2, d_model=4, n_heads=2, n_kv_heads=2, d_ff=8,
                      vocab_size=256, n_experts=4, top_k=2, moe_d_ff=3, n_shared_experts=1,
                      first_dense_layers=1)
    S, hd = 2, 2
    attn = S * (2 * 4 * (3 * 2 * hd) + 2 * 2 * hd * 4) + 2 * 3 * 2 * (hd + hd)
    dense = attn + S * 3 * 2 * 4 * 8
    moe = attn + S * (2 * 4 * 4 + 2 * 3 * 2 * 4 * 3 + 3 * 2 * 4 * 3)
    assert arith.forward_flops(cfg, S) == dense + moe + 2 * S * 4 * 256


def test_audio_forward():
    cfg = ModelConfig("a", "audio", n_layers=1, n_enc_layers=1, d_model=4, n_heads=2,
                      n_kv_heads=2, d_ff=6, vocab_size=256, enc_frames=3)
    S, T = 2, 3
    # encoder, a frame: q, k, v, o (4 x 2 x 16) and the MLP (2 x 2 x 4 x 6);
    # 9 frame pairs, 2 heads of 2, 2 x (2 + 2) a pair and head
    enc = T * (128 + 96) + 9 * 2 * 2 * 4
    # decoder, a position: self q, k, v, o; cross q, o; the MLP; the cross
    # k, v over the 3 frames; 3 causal pairs and 6 (position, frame) pairs
    dec = S * (128 + 64 + 96) + T * 2 * 2 * 16 + (3 + 6) * 2 * 2 * 4
    assert arith.forward_flops(cfg, S) == enc + dec + 2 * S * 4 * 256


def test_round_tokens():
    assert arith.round_tokens(8, 512, 2) == 8192
