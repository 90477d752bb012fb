"""Training driver.

Streams synthetic documents through the IRM-managed First-Fit packing
pipeline into fixed-length rows, trains a dense decoder on them with AdamW
(fp32 master weights and moments, bf16 compute), and runs the
fault-tolerant controller (async checkpoints, restart-on-failure).  On the
card every layer's attention is the packed-attention kernels, forward and
backward.  The fp32 master weights are drawn on the device from a seeded
``torch.Generator`` under the JAX package's init rules.  ``--device cpu``
runs the plain PyTorch versions on the CPU, at ``--smoke`` size.

``--mesh`` lays the run out as the JAX package's launcher does: the mesh
(``launch/mesh.py``), its rules and ``param_shardings`` place the fp32
masters as DTensors, ``batch_shardings`` places each batch, and the step
runs inside ``activation_sharding``.  ``local`` (the default) is every rank
of the process group on the data axis: (1, 1) on one card, (N, 1) under
``torchrun --nproc-per-node N``; ``single-pod`` and ``multi-pod`` are the
16x16 and 2x16x16 production meshes, which need that many ranks.
``none`` runs with no mesh, on plain tensors.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --device cpu --steps 20
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch olmo-1b --smoke --device cpu --steps 3    # gloo, a (4, 1) mesh
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --batch-size 4 --steps 8                       # full width, the card
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCH_NAMES, SHAPES_BY_NAME, get_config
from ..data import StreamingPipeline, synthetic_documents
from ..distributed.context import activation_sharding
from ..distributed.sharding import (
    batch_shardings,
    distribute,
    make_rules,
    param_shardings,
)
from ..kernels.packed_attention import ops as packed_ops
from ..models import build_model, init_params
from ..models.params import tree_map
from ..training import OptimizerConfig, init_opt_state, make_train_step
from ..training.controller import (
    DEFAULT_CHECKPOINT_DIR,
    TrainController,
    TrainControllerConfig,
)
from .mesh import make_local_mesh, make_production_mesh

MESHES = ["local", "single-pod", "multi-pod", "none"]

def make_params(model, seed: int, device: torch.device):
    """The model's fp32 master weights, drawn leaf by leaf on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(model.param_specs(), gen, torch.float32, device)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="local", choices=MESHES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="nothing",
                    choices=["nothing", "dots", "everything"])
    ap.add_argument("--ckpt-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(
    args: argparse.Namespace,
    *,
    params: Optional[Dict[str, Any]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    after_run: Optional[Callable[..., None]] = None,
    cfg: Any = None,
) -> Dict[str, Any]:
    """Train ``--steps`` steps; return the run's step times, tokens/s
    (over the whole run, checkpoints included, and at the median step),
    losses, grad norms, packing statistics, the last checkpoint's size and
    seconds, the packed-attention kernels' launches during the run and the
    peak device memory.

    ``params`` (fp32, on ``--device``; the same on every rank) replaces the
    drawn initial weights;
    ``compute_dtype`` is that of the forward and backward (the kernels on
    the card take bf16);
    ``cfg`` replaces ``--arch``'s configuration (one cut in depth, say).
    ``after_run(step_fn, params, opt_state, batches)`` is called once the
    controller is done, with the trained state and the batch iterator
    (under ``--mesh``, DTensors and a step that enters the mesh context).
    A process group that the run started is ended before it returns.
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass --device cpu to run the plain version on the CPU")
    cfg = cfg or get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    started_group = args.mesh != "none" and not dist.is_initialized()
    try:
        return _run(args, cfg, model, device, params, compute_dtype, after_run)
    finally:
        if started_group and dist.is_initialized():
            dist.destroy_process_group()


def _scalar(t: torch.Tensor) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _run(args, cfg, model, device, params, compute_dtype, after_run) -> Dict[str, Any]:
    shape = SHAPES_BY_NAME[args.shape]
    seq_len = args.seq_len or (256 if args.smoke else shape.seq_len)
    batch = args.batch_size or (4 if args.smoke else shape.global_batch)
    cuda = device.type == "cuda"
    if params is None:
        params = make_params(model, 0, device)
    mesh = rules = p_shard = None
    if args.mesh != "none":
        mesh = (make_local_mesh(device.type) if args.mesh == "local" else
                make_production_mesh(multi_pod=args.mesh == "multi-pod",
                                     device_type=device.type))
        rules = make_rules(mesh)
        p_shard = param_shardings(model.param_specs(), mesh, rules)
        params = tree_map(distribute, params, p_shard)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(
        model, OptimizerConfig(decay_steps=max(args.steps, 100)),
        remat_policy=args.remat, microbatches=args.microbatches,
        compute_dtype=compute_dtype, grad_shardings=p_shard)
    if mesh is not None:
        inner = step_fn

        def step_fn(params, opt_state, batch):
            with activation_sharding(mesh, rules), implicit_replication():
                return inner(params, opt_state, batch)

    pipe = StreamingPipeline(
        synthetic_documents(cfg.vocab_size, mean_len=seq_len // 3,
                            max_len=4 * seq_len, seed=0),
        seq_len=seq_len, batch_size=batch, prefetch=4,
    )
    segments: List[float] = []
    fill: List[float] = []

    def batches() -> Iterator[Dict[str, torch.Tensor]]:
        b_shard = None
        for pb in pipe:
            segments.append(float(pb.segment_ids.max(axis=1).mean()))
            fill.append(pb.real_tokens / pb.capacity)
            out = {k: torch.from_numpy(getattr(pb, k)).to(device)
                   for k in ("tokens", "labels", "segment_ids", "positions")}
            if mesh is not None:
                b_shard = b_shard or batch_shardings(out, mesh, rules)
                out = {k: distribute(v, b_shard[k]) for k, v in out.items()}
            yield out

    ctl = TrainController(step_fn, TrainControllerConfig(
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every))
    params, opt_state, start = ctl.init_state(lambda: (params, opt_state))
    mesh_shape = ({n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
                  if mesh is not None else None)
    print(f"arch={cfg.name} device={device} mesh={mesh_shape} seq={seq_len} "
          f"batch={batch} remat={args.remat} compute={compute_dtype} start={start}")

    losses: List[float] = []
    grad_norms: List[float] = []

    def on_metrics(step: int, metrics: Dict[str, torch.Tensor]) -> None:
        losses.append(_scalar(metrics["loss"]))
        grad_norms.append(_scalar(metrics["grad_norm"]))
        if step % 10 == 0 or step == start + 1:
            print(f"step {step:>5}  loss {losses[-1]:.4f}  "
                  f"grad_norm {grad_norms[-1]:.3f}")

    fwd0, bwd0 = packed_ops.launches_fwd, packed_ops.launches_bwd
    stream = batches()
    t0 = time.perf_counter()
    params, opt_state, summary = ctl.run(
        params, opt_state, stream, num_steps=args.steps, start_step=start,
        on_metrics=on_metrics)
    dt = time.perf_counter() - t0
    launches_fwd = packed_ops.launches_fwd - fwd0
    launches_bwd = packed_ops.launches_bwd - bwd0
    done = summary["final_step"] - start
    step_ms = sorted(1e3 * s for s in summary["step_times"])
    stats: Dict[str, Any] = {
        "arch": cfg.name, "device": str(device), "mesh": mesh_shape, "seq_len": seq_len,
        "batch_size": batch, "steps": done, "seconds": dt,
        "tokens_per_s": done * batch * seq_len / dt if dt > 0 else 0.0,
        "step_ms": [1e3 * s for s in summary["step_times"]],
        "step_ms_p50": step_ms[len(step_ms) // 2] if step_ms else 0.0,
        "tokens_per_s_p50_step": (batch * seq_len / (step_ms[len(step_ms) // 2] / 1e3)
                                  if step_ms else 0.0),
        "losses": losses, "grad_norms": grad_norms,
        "launches_fwd": launches_fwd, "launches_bwd": launches_bwd,
        "segments_per_row": float(np.mean(segments)) if segments else 0.0,
        "token_fill": float(np.mean(fill)) if fill else 0.0,
        "restarts": summary["restarts"], "final_step": summary["final_step"],
        "checkpoint": dict(ctl.ckpt.last_save),
        "peak_device_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                                if cuda else None),
    }
    print(f"\n{done} steps in {dt:.1f}s ({stats['tokens_per_s']:,.0f} tok/s on "
          f"{device.type}); restarts={summary['restarts']}; packed-attention "
          f"launches fwd={launches_fwd} bwd={launches_bwd}")
    if after_run is not None:
        after_run(step_fn, params, opt_state, stream)
    return stats


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
