"""Production serving driver.

Runs the IRM-scheduled continuous-batching engine against the
discrete-time simulated backend (capacity planning / control-plane soak,
``--backend sim``), or a real model executing prefill and paged decode
(``--backend local``): the weights are drawn from a seeded generator on the
device, the KV cache is a First-Fit paged pool, both bf16 (``run_local``'s
``dtype`` takes float32, the JAX package's serving dtype), and every
decode step's attention is the Hopper paged-attention kernel on the card;
an MoE model's experts run through the grouped-matmul kernel there.  Every
architecture serves: the recurrent layers carry their states in the cache,
the encoder-decoder gets the JAX package's stub frame embeddings (as many
frames as prompt tokens) and the vision model its stub patch embeddings
(``frontend_tokens`` of them, which at full width do not fit the 16-token
prompts: internvl2-1b raises there, as the JAX package's run does).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim --requests 500
  PYTHONPATH=src python -m repro_torch.launch.serve --backend local \
      --arch qwen3-8b --requests 8                        # full width, the card
  PYTHONPATH=src python -m repro_torch.launch.serve --backend local \
      --arch qwen3-8b --smoke --device cpu                # plain version, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --backend local \
      --arch qwen3-moe-30b-a3b                            # 56.9 GiB of weights
  PYTHONPATH=src python -m repro_torch.launch.serve --backend local \
      --arch jamba-v0.1-52b --n-layers 16                 # 16 of 32 layers
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..models import build_model, init_params
from ..serving import EngineConfig, ReplicaConfig, Request, ServingEngine
from ..serving.kv_cache import PagedCacheLayout

PAGE_SIZE = 16          # ReplicaConfig.page_size
MAX_PAGES_PER_SEQ = 128
DTYPE = torch.bfloat16  # weights and KV pool, unless run_local is given another


def run_sim(args: argparse.Namespace) -> None:
    cfg = EngineConfig(
        replica=ReplicaConfig(
            max_slots=args.slots, kv_pages=args.pages,
            prefill_tokens_per_s=100_000.0, decode_tokens_per_s=8_000.0,
            spinup_delay=5.0,
        ),
        max_replicas=args.replicas,
        dt=0.1,
    )
    eng = ServingEngine(cfg)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(Request(prompt_len=int(rng.integers(128, 2048)),
                           max_new_tokens=int(rng.integers(32, 512))))
    eng.run_until_drained(t_max=3600.0)
    s = eng.summary()
    print(f"completed {s['completed']}/{args.requests}  "
          f"makespan {s['makespan']:.1f}s  p50 {s['p50_latency']:.2f}s  "
          f"p99 {s['p99_latency']:.2f}s  peak replicas {s['peak_replicas']}")


def make_params(model, seed: int, device: torch.device, dtype: torch.dtype = DTYPE):
    """The model's weights in ``dtype`` (bf16 by default), drawn leaf by
    leaf on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(model.param_specs(), gen, dtype, device)


def paged_layout(cfg, num_pages: int) -> PagedCacheLayout:
    return PagedCacheLayout(num_pages=num_pages, page_size=PAGE_SIZE,
                            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                            max_pages_per_seq=MAX_PAGES_PER_SEQ)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)[:, None]


def run_local(args: argparse.Namespace, *, dtype: torch.dtype = DTYPE) -> Dict[str, Any]:
    """Prefill a batch of prompts, then decode ``--gen-tokens`` greedy
    tokens per sequence; print the ``served`` line and return the run's
    counts and host-clock times (each ended by a device synchronise).
    ``dtype`` is the weights' and the KV pool's: bf16, or float32 as the
    JAX package's ``run_local`` serves (its ``init_params`` default)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass --device cpu to run the plain version on the CPU")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = build_model(cfg)
    params = make_params(model, 0, device, dtype)
    rng = np.random.default_rng(0)

    B = min(args.requests, 8)
    prompt_len, gen = 16, args.gen_tokens
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(B, prompt_len)).astype(np.int32))
    batch = {
        "tokens": prompts.to(device),
        "segment_ids": torch.ones((B, prompt_len), dtype=torch.int32, device=device),
        "positions": torch.arange(prompt_len, dtype=torch.int32,
                                  device=device).expand(B, prompt_len),
    }
    # the JAX package's stub frontends, drawn in its order from the same rng
    if cfg.encdec:
        batch["enc_embeds"] = torch.from_numpy(
            rng.normal(size=(B, prompt_len, cfg.d_model)) * 0.02).float().to(device)
        batch["enc_segment_ids"] = torch.ones((B, prompt_len), dtype=torch.int32,
                                              device=device)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02
        ).float().to(device)
    cache = model.init_paged_cache(paged_layout(cfg, args.pages), dtype, device)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    toks = greedy(logits)
    sync()
    t_prefill = time.perf_counter()
    out: List[torch.Tensor] = [toks]
    for _ in range(gen):
        logits, cache = model.decode_step(params, {"tokens": toks}, cache)
        toks = greedy(logits)
        out.append(toks)
    sync()
    t1 = time.perf_counter()
    dt = t1 - t0
    print(f"served {B} sequences x {gen} tokens in {dt:.2f}s "
          f"({B * gen / dt:.1f} tok/s on {device.type})")
    return {
        "sequences": B, "gen_tokens": gen, "seconds": dt,
        "prefill_s": t_prefill - t0, "decode_s": t1 - t_prefill,
        "tokens": torch.cat(out, dim=1).cpu(),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "pages_used": cache["alloc"].used_pages,
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sim", choices=["sim", "local"])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--replicas", type=int, default=5)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pages", type=int, default=1024)
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the (decoder) depth to this many layers, a multiple "
                         "of the layer pattern's period (default: the config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.backend == "sim":
        run_sim(args)
    else:
        run_local(args)


if __name__ == "__main__":
    main()
