"""The program under test, as the drivers reach it: the port's configuration
built from a configuration file, and the benchmark's weights handed over in
the port's parameter layout.

The file's numbers are what runs: they replace the port's registry entry
(``port_arch``) field by field, and the port's parameter specs have to take
the benchmark's weights shape for shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

__all__ = ["arch_config", "to_port", "from_port"]


def arch_config(cfg: Dict) -> Any:
    """The port's ``ArchConfig`` for a configuration file."""
    from repro_torch.configs import get_config

    fields = {
        "n_layers": cfg["num_hidden_layers"], "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"], "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg["head_dim"], "d_ff": cfg["intermediate_size"],
        "vocab_size": cfg.get("embedding_size", cfg["vocab_size"]),
        "rope_theta": float(cfg["rope_theta"]), "tie_embeddings": cfg["tie_word_embeddings"],
        "qk_norm": cfg["qk_norm"], "norm_type": cfg["norm"], "act": "swiglu",
        "moe": None, "layer_pattern": None, "sliding_window": 0,
    }
    return dataclasses.replace(get_config(cfg["port_arch"]), **fields)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """An embedding table with zero rows up to ``rows`` (the port pads its
    vocabulary; the padding rows take no part in the published model)."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros(rows - t.shape[0], t.shape[1])])


def to_port(w: Dict[str, torch.Tensor], model: Any) -> Dict[str, Any]:
    """The benchmark's weights (``weights.draw``) as the port's parameter
    tree: views of the same storage, but for the norms' weights, which the
    port keeps as 1 + scale, and the vocabulary's zero padding."""
    cfg = model.cfg
    L, d, H, KVH, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    specs = model.param_specs()
    vp = specs["embed"].shape[0]

    def scale(name):
        return {"scale": w[name] - 1}

    mixer = {"wq": w["wq"].view(L, d, H, hd), "wk": w["wk"].view(L, d, KVH, hd),
             "wv": w["wv"].view(L, d, KVH, hd), "wo": w["wo"].view(L, H, hd, d)}
    if cfg.qk_norm:
        mixer["q_norm"], mixer["k_norm"] = w["q_norm"] - 1, w["k_norm"] - 1
    rms = cfg.norm_type == "rmsnorm"
    block = {"ln1": scale("ln1") if rms else {}, "ln2": scale("ln2") if rms else {},
             "mixer": dict(sorted(mixer.items())),
             "ffn": {"w_down": w["w_down"], "w_gate": w["w_gate"], "w_up": w["w_up"]}}
    tree = {"blocks": {"0": dict(sorted(block.items()))}, "embed": _pad_rows(w["embed"], vp),
            "final_norm": scale("final_norm") if rms else {}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _pad_rows(w["lm_head"], vp)
    _same_shapes(specs, tree)
    return dict(sorted(tree.items()))


def _same_shapes(specs: Any, tree: Any, path: str = "") -> None:
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(specs) != set(tree):
            raise ValueError(f"the port's parameters at {path or '/'} are "
                             f"{sorted(specs)}, the benchmark's {sorted(tree)}")
        for k in specs:
            _same_shapes(specs[k], tree[k], f"{path}/{k}")
    elif tuple(specs.shape) != tuple(tree.shape):
        raise ValueError(f"{path}: the port wants {tuple(specs.shape)}, "
                         f"the benchmark has {tuple(tree.shape)}")


def from_port(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree in the port's layout (parameters, or a moment of them) under
    the benchmark's names, stacked leaves flattened as the benchmark keeps
    them; the norms' scales as they are (a change or gradient of 1 + s is
    that of s)."""
    blk = tree["blocks"]["0"]
    L = blk["mixer"]["wq"].shape[0]
    out = {"embed": tree["embed"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    for name, t in blk["mixer"].items():
        out[name] = t.reshape(L, t.shape[1] * t.shape[2], -1) if name == "wo" else (
            t.reshape(L, t.shape[1], -1) if t.dim() == 4 else t)
    out.update(blk["ffn"])
    for name in ("ln1", "ln2"):
        if blk.get(name):
            out[name] = blk[name]["scale"]
    if tree.get("final_norm"):
        out["final_norm"] = tree["final_norm"]["scale"]
    return out
