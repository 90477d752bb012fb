"""Batched prefill: the port's ``prefill`` on a fresh paged cache, then a
greedy first token returned to the host, under an open loop.

Requests arrive on a schedule fixed by the traffic file: ``arrival_burst``
at once when the window opens (a queue already full, for a cell above the
knee), then gaps of mean ``1 / arrival_rate`` s drawn from ``arrival_seed``,
Gamma-distributed with the coefficient of variation ``arrival_cv`` (1 is
Poisson; above 1 the arrivals come in bursts); request i has the prompt
length ``prompt_lengths[i % len]``.  Whenever the server is free it takes
the requests that have arrived, oldest first, ``batch`` at most, pads the
rows to the longest of them (the port takes one prompt a row), and serves
them: submit, a fresh cache, prefill, the first tokens on the host.  A
request's time to its first token counts from the moment it was due.  The
window holds the requests due in its first ``--seconds``.  With
``"window": "arrivals"`` (a cell below the knee) it closes when the last of
them has its first token, so every run serves the same requests; with
``"window": "time"`` (a cell above the knee, whose queue grows all through
the run) it closes at the end of the first batch that ends past
``--seconds`` with a whole number of ``cycle_batches`` served (a full queue
takes the lengths in the same batches each pass, so every run's window
holds the same mix), and the requests still queued go unserved.  Set-up warms
each full batch of the lengths' first pass once; a traced run replays the
schedule's first ``traced_seconds`` after the window.  The check keeps the
batches that ``Sample`` picks as they are served.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import traffic as traffic_gen
from ..counts import prefill_flops
from ..port import arch_config, to_port
from ..reference.judge import first_fit_pages, prefill_numbers, slots_of
from ..weights import draw

__all__ = ["Program", "Sample", "arrivals", "length_of", "prompts", "run"]


def arrivals(traffic: Dict, seconds: float) -> np.ndarray:
    """The schedule's arrival times (s from the window's start) before
    ``seconds``: the same prefix whatever ``seconds`` is."""
    r = np.random.default_rng(traffic["arrival_seed"])
    shape = traffic["arrival_cv"] ** -2.0
    scale = 1.0 / (traffic["arrival_rate"] * shape)
    t, out = 0.0, [0.0] * traffic["arrival_burst"]
    while t < seconds:
        out.append(t)
        t += r.gamma(shape, scale)
    return np.array(out)


def length_of(traffic: Dict, i: int) -> int:
    lengths = traffic["prompt_lengths"]
    return lengths[i % len(lengths)]


class Sample:
    """The served batches the check keeps, decided as each is served: the
    one that holds the first request of the longest prompt; and, while the
    kept prompt tokens stay within ``check_tokens``, the first batch of each
    size and each batch that a draw from the seed picks, with the chance
    ``check_share``."""

    def __init__(self, traffic: Dict, seed: int):
        self.longest = int(np.argmax(traffic["prompt_lengths"]))
        self.share, self.budget = traffic["check_share"], traffic["check_tokens"]
        self.draws = traffic_gen.rng(seed, traffic_gen.SAMPLE)
        self.sizes: set = set()
        self.tokens = 0

    def keep(self, first: int, lengths: List[int]) -> bool:
        drawn = self.draws.random() < self.share  # one draw a batch, kept or not
        wanted = drawn or len(lengths) not in self.sizes
        if first <= self.longest < first + len(lengths) or (
                wanted and self.tokens + sum(lengths) <= self.budget):
            self.sizes.add(len(lengths))
            self.tokens += sum(lengths)
            return True
        return False


def prompts(cfg: Dict, lengths: List[int], seed: int, *tags: int) -> List[np.ndarray]:
    """Prompts of ``lengths``: the window's request i is tagged i."""
    return traffic_gen.prompt_ids(lengths, cfg["vocab_size"], seed, *tags)


class Program:
    """The port's model, its weights and a cache layout, driven from one
    seed."""

    def __init__(self, ctx):
        from repro_torch.launch.serve import greedy
        from repro_torch.models import build_model
        from repro_torch.serving.kv_cache import PagedCacheLayout

        self.ctx, cfg, tr = ctx, ctx.cell.config, ctx.cell.traffic
        self.cfg, self.greedy = cfg, greedy
        self.model = build_model(arch_config(cfg))
        self.dtype = getattr(torch, cfg["dtype"])
        self.params = to_port(draw(cfg, ctx.seed, self.dtype, ctx.device), self.model)
        per_request = -(-tr["cache_tokens_per_request"] // cfg["page_size"])
        self.layout = PagedCacheLayout(
            num_pages=tr["batch"] * per_request, page_size=cfg["page_size"],
            n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
            max_pages_per_seq=per_request)

    def serve(self, ids: List[np.ndarray]):
        """One batch: submit, a fresh cache, prefill, the first tokens on the
        host.  Returns (first tokens, logits, cache, the host's time when
        the first tokens arrived)."""
        spans, dev = self.ctx.spans, self.ctx.device
        B, S = len(ids), max(len(x) for x in ids)
        tokens = np.zeros((B, S), np.int32)
        seg = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        for b, x in enumerate(ids):
            tokens[b, :len(x)], seg[b, :len(x)], pos[b, :len(x)] = x, 1, np.arange(len(x))
        with spans("submit"):
            batch = {"tokens": torch.from_numpy(tokens).to(dev),
                     "segment_ids": torch.from_numpy(seg).to(dev),
                     "positions": torch.from_numpy(pos).to(dev)}
        with spans("cache_init"):
            cache = self.model.init_paged_cache(self.layout, self.dtype, dev)
        with spans("prefill"):
            logits, cache = self.model.prefill(self.params, batch, cache)
        with spans("first_token"):
            first = self.greedy(logits)[:, 0].cpu().numpy()
        return first, logits, cache, time.perf_counter()

    def open_loop(self, due: np.ndarray, ids: List[np.ndarray], sample: Sample = None,
                  stop: float = np.inf) -> Dict[str, Any]:
        """Serve the requests due at ``due`` (s from now) as they arrive,
        until all are served or a batch ends past ``stop`` with a whole
        number of ``cycle_batches`` served.  Returns each served request's
        time to its first token and its wait before its batch was taken,
        the seconds until the last first token, the batches' prompt
        lengths, and the check's view of each batch that ``sample`` keeps."""
        tr, n = self.ctx.cell.traffic, len(due)
        batch, cycle = tr["batch"], tr["cycle_batches"]
        ttft, wait = np.zeros(n), np.zeros(n)
        batches: List[List[int]] = []
        kept: List[Dict[str, Any]] = []
        t0, i = time.perf_counter(), 0
        while i < n and (time.perf_counter() - t0 < stop or len(batches) % cycle):
            idle = due[i] - (time.perf_counter() - t0)
            if idle > 0:
                time.sleep(idle)
            now = time.perf_counter() - t0
            j = i + 1
            while j < n and j - i < batch and due[j] <= now:
                j += 1
            first, logits, cache, done = self.serve(ids[i:j])
            ttft[i:j] = done - t0 - due[i:j]
            wait[i:j] = now - due[i:j]
            batches.append([len(x) for x in ids[i:j]])
            if sample is not None and sample.keep(i, batches[-1]):
                kept.append(self.kept(ids[i:j], first, logits, cache))
            del logits, cache
            i = j
        return {"ttft": ttft[:i], "wait": wait[:i], "seconds": time.perf_counter() - t0,
                "batches": batches, "kept": kept}

    def kept(self, ids, first, logits, cache) -> Dict[str, Any]:
        """What the check reads of one batch: the page table, the logits,
        the served tokens, and every layer's K and V at the slots where
        First-Fit puts the prompts' tokens, gathered now, so that the pool
        is freed with the batch."""
        lengths = [len(x) for x in ids]
        slots = slots_of(first_fit_pages(lengths, self.cfg["page_size"]), lengths,
                         self.cfg["page_size"], self.ctx.device)
        k, v = (cache[n].flatten(1, 2)[:, slots] for n in ("k", "v"))
        return {"ids": ids, "pages": [cache["alloc"].seq_pages(b) for b in range(len(ids))],
                "logits": logits, "tokens": first, "kv": lambda l: (k[l], v[l])}

    def free(self) -> None:
        del self.params
        if self.ctx.cuda:
            torch.cuda.empty_cache()


def run(ctx) -> Dict[str, Any]:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    due = arrivals(tr, ctx.seconds)
    lengths = [length_of(tr, i) for i in range(len(due))]
    ids = [prompts(cfg, [n], ctx.seed, i)[0] for i, n in enumerate(lengths)]
    prog = Program(ctx)
    ctx.mark("built")
    first_pass = tr["prompt_lengths"]
    for b in range(0, len(first_pass), tr["batch"]):
        prog.serve(prompts(cfg, first_pass[b:b + tr["batch"]], ctx.seed, traffic_gen.WARMUP, b))
    ctx.setup_done()

    stop = ctx.seconds if tr["window"] == "time" else np.inf
    out = prog.open_loop(due, ids, Sample(tr, ctx.seed), stop)
    ctx.mark("window")
    lengths = lengths[:len(out["ttft"])]
    counters = {"window_s": out["seconds"], "requests": len(lengths),
                "prompt_tokens": sum(lengths), "model_flops": prefill_flops(cfg, lengths),
                "batches": len(out["batches"]),
                "checked_requests": sum(len(b["ids"]) for b in out["kept"]),
                "ttft_p95_s": float(np.percentile(out["ttft"], 95)),
                "wait_p95_s": float(np.percentile(out["wait"], 95)),
                "service_p95_s": float(np.percentile(out["ttft"] - out["wait"], 95))}

    trace = None
    if ctx.trace:
        def segment():
            t = arrivals(tr, tr["traced_seconds"])
            warm = [prompts(cfg, [length_of(tr, i)], ctx.seed, traffic_gen.WARMUP, 1, i)[0]
                    for i in range(len(t))]
            return {"lengths": prog.open_loop(t, warm, stop=stop)["batches"]}
        trace = ctx.profile(segment)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    prog.free()

    return {"end_to_end": {"prompt_tokens_per_s": sum(lengths) / out["seconds"],
                           "ttft_p95_ms": 1e3 * counters["ttft_p95_s"]},
            "counters": counters, "trace": trace, "memory_peak_bytes": peak,
            "attempted": len(lengths), "failed": 0,
            "checks": prefill_numbers(cfg, out["kept"], ctx.seed, ctx.device)}
