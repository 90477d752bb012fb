"""Packed training: the port's train step fed by its streaming pipeline.

Set-up builds one train step (``make_train_step``: bf16 compute over fp32
masters, AdamW), one ``StreamingPipeline`` (the IRM-managed First-Fit
packer) over the seed's documents, and drives them through the first
``check_steps`` steps, the steps the check compares: the same step and
feed then run the window.  The window ends after the first step that ends
past ``--seconds``; a traced run then profiles ``traced_steps`` more.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import traffic as traffic_gen
from ..counts import train_flops
from ..port import arch_config, from_port, to_port
from ..reference.judge import leaf_norms, train_numbers, train_outputs
from ..reference.model import Precision
from ..weights import draw

__all__ = ["Program", "run"]

_ROW_KEYS = ("tokens", "labels", "segment_ids", "positions")


class Program:
    """The port's train step and pipeline, driven from one seed."""

    def __init__(self, ctx):
        from repro_torch.data import StreamingPipeline
        from repro_torch.models import build_model
        from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

        self.ctx, cfg, tr = ctx, ctx.cell.config, ctx.cell.traffic
        self.cfg = cfg
        self.model = build_model(arch_config(cfg))
        self.params = to_port(draw(cfg, ctx.seed, torch.float32, ctx.device), self.model)
        self.opt_cfg = OptimizerConfig(**cfg["optimizer"])
        self.opt_state = init_opt_state(self.params)
        self.step_fn = make_train_step(self.model, self.opt_cfg, remat_policy=cfg["remat"],
                                       compute_dtype=getattr(torch, cfg["compute_dtype"]))
        docs = traffic_gen.documents(tr["documents"], cfg["vocab_size"], ctx.seed)
        self.pipe = StreamingPipeline(docs, seq_len=tr["seq_len"],
                                      batch_size=cfg["train_rows_per_step"],
                                      prefetch=tr["prefetch"])
        self.batches = iter(self.pipe)
        self.rows: List[Dict[str, np.ndarray]] = []
        self.wait_s = 0.0

    def step(self) -> Dict[str, torch.Tensor]:
        """One step on the pipeline's next batch, as the launcher feeds it."""
        spans = self.ctx.spans
        t = time.perf_counter()
        with spans("next_batch"):
            pb = next(self.batches)
        self.wait_s += time.perf_counter() - t
        self.rows.append({k: getattr(pb, k) for k in _ROW_KEYS})
        with spans("to_device"):
            batch = {k: torch.from_numpy(getattr(pb, k)).to(self.ctx.device) for k in _ROW_KEYS}
        with spans("train_step"):
            self.params, self.opt_state, metrics = self.step_fn(self.params, self.opt_state, batch)
        return metrics

    def first_steps(self, n: int) -> Dict[str, Any]:
        """The first ``n`` steps, and what they produced for the check: the
        losses, the first gradient as AdamW got it (from its first moment
        and the reported norm, which undo the clipping) and the weights'
        change over the ``n`` steps."""
        start = {k: t.clone() for k, t in from_port(self.params).items()}
        losses, grad = [], None
        for i in range(n):
            metrics = self.step()
            losses.append(metrics["loss"])
            if i == 0:
                clip = torch.clamp(self.opt_cfg.grad_clip_norm
                                   / metrics["grad_norm"].clamp(min=1e-9), max=1.0)
                m = from_port(self.opt_state["m"])
                grad = leaf_norms({k: t / ((1 - self.opt_cfg.b1) * clip) for k, t in m.items()})
        now = from_port(self.params)
        change = leaf_norms({k: now[k] - start[k] for k in now})
        return {"losses": [float(x) for x in losses], "grad": grad, "change": change}

    def free(self) -> None:
        del self.params, self.opt_state, self.step_fn
        if self.ctx.cuda:
            torch.cuda.empty_cache()


def run(ctx) -> Dict[str, Any]:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    prog = Program(ctx)
    ctx.mark("built")
    first = prog.first_steps(tr["check_steps"])
    ctx.setup_done()

    n0, wait0 = len(prog.rows), prog.wait_s
    t0 = time.perf_counter()
    while True:
        prog.step()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    ctx.mark("window")
    rows = prog.rows[n0:]
    real = sum(int((r["segment_ids"] > 0).sum()) for r in rows)
    counters = {"window_s": window_s, "steps": len(rows), "real_tokens": real,
                "capacity_tokens": sum(r["segment_ids"].size for r in rows),
                "batch_wait_s": prog.wait_s - wait0,
                "model_flops": train_flops(cfg, [r["segment_ids"] for r in rows],
                                           [r["labels"] for r in rows])}

    trace = None
    if ctx.trace:
        def segment():
            k = len(prog.rows)
            for _ in range(tr["traced_steps"]):
                prog.step()
            return {"segment_ids": [r["segment_ids"] for r in prog.rows[k:]]}
        trace = ctx.profile(segment)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    prog.free()
    ctx.mark("traced")

    produced = dict(first, rows=prog.rows)
    ref = train_outputs(cfg, tr, ctx.seed, len(prog.rows), ctx.device, Precision("fp32"))
    return {"end_to_end": {"train_tokens_per_s": real / window_s},
            "counters": counters, "trace": trace, "memory_peak_bytes": peak,
            "attempted": len(rows), "failed": 0, "checks": train_numbers(produced, ref)}
