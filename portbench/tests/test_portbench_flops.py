"""The benchmark's operation and byte counts against hand counts at
smoke sizes."""
from __future__ import annotations

from portbench_scratch import REPO

from portbench import harness

BENCH = harness.Bench(REPO)
# d 8, 2 heads of 4 (KV 2), ff 16, vocab 10, 2 decoder and 1 encoder layers
W = {"d_model": 8, "num_heads": 2, "num_kv_heads": 2, "head_dim": 4, "d_ff": 16,
     "vocab_size": 10, "num_layers": 2, "encoder_layers": 1}


def test_attention_cost():
    att = BENCH.module("flops", "attention")
    assert att.pairs(3, 3, True) == 6 and att.pairs(2, 5, True) == 4 + 5
    assert att.pairs(2, 5, False) == 10
    call = {"B": 2, "H": 4, "KV": 2, "hd": 8, "Sq": 3, "Skv": 5, "causal": False}
    # 4 hd per pair and head: 4*8 * 15 pairs * 4 heads * 2 rows; q, o 2*3*4*8, k, v 2*5*2*8
    assert att.cost(call) == (4 * 8 * 15 * 4 * 2, 2 * 2 * (2 * 3 * 4 * 8 + 2 * 5 * 2 * 8))


def test_whisper_prefill_by_hand():
    f = BENCH.module("flops", "whisper")
    # one row, prompt 2, memory 3. Encoder layer per frame: q k v o 4*(2*8*8),
    # mlp 2*(2*8*16) = 512 + 512; 3 frames = 3072; attention 4*4*2*9 = 288.
    enc = 3072 + 288
    xkv = 2 * 3 * 2 * (2 * 8 * 8)  # 2 layers, 3 frames, k and v
    # decoder token: self 512, cross q, o 256, mlp 512 = 1280; 2 tokens, 2 layers
    dec = 2 * 2 * 1280 + 2 * 4 * 4 * 2 * (3 + 2 * 3)  # pairs: causal 3, cross 6
    assert f.prefill(W, 1, 2, 3)["flops"] == enc + xkv + dec + 2 * 8 * 10


def test_whisper_decode_by_hand():
    f = BENCH.module("flops", "whisper")
    # one step at position 2 (3 positions seen) over memory 3, one row
    flops = 2 * 1280 + 2 * 8 * 10 + 2 * 4 * 4 * 2 * (3 + 3)
    w = 2 * (2 * (4 * 64 + 2 * 64 + 2 * 128 + 24) + 80 + 8)  # bf16 weights, table, final norm
    cache = 2 * 2 * (2 * 2 * 4 * (3 + 3) + 2 * 2 * 4)  # K, V read (self 3, cross 3), new K, V
    assert f.decode(W, 1, 2, 3, 1) == {"flops": flops, "bytes": w + cache}


def test_rwkv6_by_hand():
    f = BENCH.module("flops", "rwkv6")
    m = {"d_model": 8, "d_ff": 16, "ssm_head_dim": 4, "vocab_size": 10, "num_layers": 1}
    tok = 5 * 2 * 64 + 2 * 2 * 8 * 32 + 2 * 2 * 8 * 16 + 4 * 4 * 8
    assert f.prefill(m, 2, 3)["flops"] == 2 * (3 * tok + 2 * 8 * 10)
    w = 2 * (5 * 64 + 2 * 8 * 32 + 2 * 8 * 16 + 11 * 8 + 80 + 8)
    assert f.decode(m, 2, 3, 0, 1) == {"flops": 2 * (tok + 160),
                                       "bytes": w + 2 * 4 * 2 * 2 * 16}
    assert f.attention_calls(m, 2, 3) == []
