"""``counts.py`` against brute-force counts over small masks and weights."""

import numpy as np
import pytest

from portbench import counts
from portbench.conftest import smoke_config
from portbench.weights import leaf_shapes


def brute_pairs(seg):
    total = 0
    for row in np.atleast_2d(seg):
        for i in range(len(row)):
            for j in range(i + 1):
                total += int(row[i] > 0 and row[i] == row[j])
    return total


@pytest.mark.parametrize("seed", range(6))
def test_visible_pairs_against_the_mask(seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 4, size=(3, 37))  # documents not contiguous, padding between
    if seed % 2:
        seg = np.sort(seg, axis=1)[:, ::-1]  # contiguous runs, padding at the end
    assert counts.visible_pairs(seg) == brute_pairs(seg)
    assert counts.attention_fwd_ops(seg, 4, 16) == 4 * 16 * 4 * brute_pairs(seg)
    assert counts.attention_bwd_ops(seg, 4, 16) == 10 * 16 * 4 * brute_pairs(seg)


def test_bytes_count_each_tensor_once():
    B, S, H, KVH, D = 2, 8, 4, 2, 16
    q, kv, seg, lse = B * S * H * D * 2, B * S * KVH * D * 2, B * S * 4, B * H * S * 4
    assert counts.attention_fwd_bytes(B, S, H, KVH, D, 2, False) == q + 2 * kv + 2 * seg + q + lse
    assert counts.attention_fwd_bytes(B, S, H, KVH, D, 2, True) == q + 2 * kv + 2 * seg + 2 * q + lse
    # in: q k v, two segment ids, out, its residual, dO, lse; out: dq dk dv
    assert counts.attention_bwd_bytes(B, S, H, KVH, D, 2) == (
        q + 2 * kv + 2 * seg + 3 * q + lse + q + 2 * kv)


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-8b"])
def test_model_flops_against_the_weights(name):
    cfg = smoke_config(name)
    layer = sum(int(np.prod(s)) for n, s, init in leaf_shapes(cfg)
                if init == "normal" and n not in ("embed", "lm_head"))
    assert counts.matmul_params(cfg) == layer
    seg = np.array([[1, 1, 1, 2, 2, 0]])
    lab = np.array([[5, 6, -1, 7, -1, -1]])
    L, H, D, d = 2, 4, 16, 64
    rows = cfg.get("embedding_size", cfg["vocab_size"])
    want = 6 * 5 * layer + 6 * 3 * d * rows + L * 14 * D * H * (6 + 3)
    assert counts.train_flops(cfg, [seg], [lab]) == want
    want = 2 * 5 * layer + 2 * 2 * d * cfg["vocab_size"] + L * 4 * D * H * (6 + 3)
    assert counts.prefill_flops(cfg, [3, 2]) == want
