"""The model's weights, drawn from the run's seed on the device.

One ``torch.Generator`` on the device, one draw for each stacked leaf (all
layers of one matrix at once), in the type the weights are kept in: a few
large calls.  Every matrix is N(0, ``init_std``); norm weights are 1.  The
same seed, dtype and device give the same values, which is how the
reference gets the weights again without taking them from the program.

The tree is the benchmark's own, keyed by the plain names below with the
layers stacked in front: ``wq`` (L, d, H hd), ``wk``/``wv`` (L, d, KVH hd),
``wo`` (L, H hd, d), ``w_gate``/``w_up`` (L, d, f), ``w_down`` (L, f, d),
``embed`` and, untied, ``lm_head`` (V, d); RMSNorm models add ``ln1``,
``ln2`` (L, d), ``final_norm`` (d) and, with qk-norm, ``q_norm``,
``k_norm`` (L, hd).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .traffic import WEIGHTS, seed_words

__all__ = ["leaf_shapes", "draw", "generator"]


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, "normal" or "ones") of every leaf, in drawing order."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KVH, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    f, V = cfg["intermediate_size"], cfg.get("embedding_size", cfg["vocab_size"])
    out = [("embed", (V, d), "normal")]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (V, d), "normal"))
    out += [("wq", (L, d, H * hd), "normal"), ("wk", (L, d, KVH * hd), "normal"),
            ("wv", (L, d, KVH * hd), "normal"), ("wo", (L, H * hd, d), "normal"),
            ("w_gate", (L, d, f), "normal"), ("w_up", (L, d, f), "normal"),
            ("w_down", (L, f, d), "normal")]
    if cfg["norm"] == "rmsnorm":
        out += [("ln1", (L, d), "ones"), ("ln2", (L, d), "ones"), ("final_norm", (d,), "ones")]
    if cfg["qk_norm"]:
        out += [("q_norm", (L, hd), "ones"), ("k_norm", (L, hd), "ones")]
    return out


def generator(seed: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence(seed_words(seed) + [WEIGHTS]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) | int(state[1]) << 31)


def draw(cfg: Dict, seed: int, dtype: torch.dtype, device: torch.device) -> Dict[str, torch.Tensor]:
    gen = generator(seed, device)
    std = cfg["assumed"]["init_std"]
    out = {}
    for name, shape, init in leaf_shapes(cfg):
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)
    return out
