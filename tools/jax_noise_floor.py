#!/usr/bin/env python3
"""How far the JAX package's own numbers move under rounding-level noise,
on the CPU at smoke size: the floor under which the port cannot be held to
the reference.

Run from the root of a checkout (no card needed):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/jax_noise_floor.py \
        [--arch jamba-v0.1-52b ...] [--seeds 4]

For each architecture (default: the four that ``tests/test_torch_archs.py``
holds to JAX, and qwen3-8b beside them) it runs the JAX package twice on
the same inputs, once on its ``init_params(PRNGKey(0))`` weights and once
on the same weights with every entry multiplied by ``1 + 2^-24 z`` (z
standard normal, one draw per seed): a change at the level of one fp32
rounding.  It reads what ``tests/test_torch_archs.py`` compares:

  - ``grad_norm``: the relative change of one train step's gradient norm
    (``make_batch(cfg, "train", 2, 64, seed=1)``, f32 compute);
  - ``logits``: the largest change of any logit over a prefill of two
    right-padded prompts (20 and 13 tokens) and two decode steps on the
    prefill's cache zero-padded by 2 slots (the serving test's oracle).

It prints one JSON line per architecture with the largest reading over the
seeds.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import build_model, init_params, make_batch
from repro.training import OptimizerConfig, init_opt_state, make_train_step

ARCHS = ["jamba-v0.1-52b", "xlstm-125m", "seamless-m4t-medium", "internvl2-1b", "qwen3-8b"]


def serve_inputs(cfg, rng, lens):
    """The serving test's prompts and stub frontend inputs."""
    n, width = len(lens), max(lens)
    tokens = np.zeros((n, width), np.int32)
    seg = np.zeros((n, width), np.int32)
    for b, m in enumerate(lens):
        tokens[b, :m] = rng.integers(1, cfg.vocab_size, size=m)
        seg[b, :m] = 1
    batch = {"tokens": tokens, "segment_ids": seg,
             "positions": np.broadcast_to(np.arange(width, dtype=np.int32), (n, width))}
    if cfg.encdec:
        enc_seg = np.ones((n, 24), np.int32)
        enc_seg[-1, 17:] = 0
        batch["enc_embeds"] = (rng.normal(size=(n, 24, cfg.d_model)) * 0.02).astype(np.float32)
        batch["enc_segment_ids"] = enc_seg
    if cfg.frontend == "vision":
        batch["vision_embeds"] = (rng.normal(size=(n, cfg.frontend_tokens, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in batch.items()}


def padded(cache, extra):
    def pad(tree):
        return {k: (pad(v) if isinstance(v, dict) else
                    jnp.pad(v, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
                    if k in ("k", "v") else v) for k, v in tree.items()}
    return dict(cache, blocks=pad(cache["blocks"]))


def serve_logits(model, params, cfg):
    rng = np.random.default_rng(2)
    logits, cache = model.prefill(params, serve_inputs(cfg, rng, [20, 13]))
    outs, cache = [np.asarray(logits)], padded(cache, 2)
    for _ in range(2):
        tok = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        logits, cache = model.decode_step(params, {"tokens": jnp.asarray(tok)}, cache)
        outs.append(np.asarray(logits))
    return outs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    for arch in args.arch:
        cfg = get_config(arch).smoke()
        model = build_model(cfg)
        params = init_params(model.param_specs(), jax.random.PRNGKey(0))
        batch = make_batch(cfg, "train", 2, 64, seed=1)
        step = make_train_step(model, OptimizerConfig(learning_rate=1e-3),
                               compute_dtype=jnp.float32)

        def grad_norm(p):
            return float(step(p, init_opt_state(p), batch)[2]["grad_norm"])

        g0, l0 = grad_norm(params), serve_logits(model, params, cfg)
        dg, dl = [], []
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            moved = jax.tree.map(lambda a: a * (1 + 2.0**-24 * rng.standard_normal(
                a.shape).astype(np.float32)), params)
            dg.append(abs(grad_norm(moved) - g0) / g0)
            dl.append(max(float(np.abs(a - b).max())
                          for a, b in zip(serve_logits(model, moved, cfg), l0)))
        print(json.dumps({"arch": arch, "grad_norm": g0, "grad_norm_rel_change": max(dg),
                          "max_abs_logit": max(float(np.abs(a).max()) for a in l0),
                          "logit_max_abs_change": max(dl)}), flush=True)


if __name__ == "__main__":
    main()
