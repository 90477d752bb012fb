"""End-to-end driver on the PyTorch port: stream -> First-Fit packing ->
train a ~100M LM, on the card.

The port's counterpart of ``examples/train_stream.py``, with its arguments
and its printout:

  - documents stream in from a synthetic scientific-corpus source,
  - the IRM-instrumented pipeline profiles document sizes, auto-scales
    packer shards from queue pressure, and First-Fit-packs rows,
  - a ~100M-parameter decoder (the same code path as the assigned archs)
    trains with the fault-tolerant controller: async checkpoints,
    automatic restart, straggler tracking.

As ``launch.train`` does, the step computes in bf16 over fp32 master
weights and moments; on the card every layer's attention is the
packed-attention kernels, forward and backward (head dim 64), whose
launches the run prints.  The weights are drawn from a seeded
``torch.Generator`` under the JAX package's init rules, so they are not
the JAX example's numbers.  ``--device cpu`` runs the plain PyTorch
versions; without it the run needs a card.

Usage:
  PYTHONPATH=src python examples/torch_train_stream.py --steps 300
  PYTHONPATH=src python examples/torch_train_stream.py --steps 100 --fail-at 60
  PYTHONPATH=src python examples/torch_train_stream.py --steps 5 --device cpu
"""

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import StreamingPipeline, synthetic_documents
from repro_torch.kernels.packed_attention import ops as packed_ops
from repro_torch.launch.train import make_params
from repro_torch.models import build_model
from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.training.controller import TrainController, TrainControllerConfig

# ~100M-parameter decoder-only LM (untied embeddings: 2*50304*640 = 64M,
# blocks: 10 * (4*640^2 + 3*640*2560) = 66M  ->  ~130M total)
LM_100M = ArchConfig(
    name="lm-100m",
    family="dense",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=10,
    d_ff=2560,
    vocab_size=50304,
    norm_type="rmsnorm",
    act="swiglu",
    source="examples/train_stream.py",
)
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_stream")


def train_stream(
    cfg: ArchConfig,
    *,
    steps: int,
    seq_len: int,
    batch_size: int,
    ckpt_dir: str,
    device: str = "cuda",
    fail_at: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    params: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps over the streamed, packed rows
    under the controller (a checkpoint every 50 steps, resumed from
    ``ckpt_dir`` if one is there); print the JAX example's lines and return
    the run: losses, restarts, final step, stragglers, pipeline stats and
    the packed kernels' launches.  ``params`` (fp32 on ``device``) replace
    the drawn weights."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass --device cpu to run the plain version on the CPU")
    model = build_model(cfg)
    n_params, _ = cfg.param_counts()
    print(f"model: {cfg.name} ({n_params / 1e6:.0f}M params)")

    if params is None:
        params = make_params(model, 0, dev)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(
        model,
        OptimizerConfig(learning_rate=3e-4, warmup_steps=50, decay_steps=steps),
        remat_policy="nothing", compute_dtype=compute_dtype)

    docs = synthetic_documents(cfg.vocab_size, mean_len=180, max_len=1024,
                               seed=0, limit=None)
    pipe = StreamingPipeline(docs, seq_len=seq_len, batch_size=batch_size, prefetch=4)

    def batches():
        for pb in pipe:
            yield {k: torch.from_numpy(getattr(pb, k)).to(dev)
                   for k in ("tokens", "labels", "segment_ids", "positions")}

    ctl = TrainController(step_fn, TrainControllerConfig(
        checkpoint_dir=ckpt_dir, checkpoint_every=50, async_checkpoint=True))
    params, opt_state, start = ctl.init_state(lambda: (params, opt_state))
    if start:
        print(f"resumed from checkpoint at step {start}")

    t0 = time.perf_counter()
    losses = []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == start + 1:
            dt = time.perf_counter() - t0
            tput = (step - start) * batch_size * seq_len / dt
            print(f"step {step:>5}  loss {metrics['loss']:.4f}  "
                  f"grad_norm {metrics['grad_norm']:.3f}  "
                  f"lr {metrics['lr']:.2e}  {tput:,.0f} tok/s")

    fwd0, bwd0 = packed_ops.launches_fwd, packed_ops.launches_bwd
    params, opt_state, summary = ctl.run(
        params, opt_state, batches(), num_steps=steps, start_step=start,
        fail_at=fail_at, on_metrics=on_metrics)
    seconds = time.perf_counter() - t0
    launches = {"packed_fwd": packed_ops.launches_fwd - fwd0,
                "packed_bwd": packed_ops.launches_bwd - bwd0}

    stats = pipe.stats()
    print("\n--- done ---")
    print(f"final step: {summary['final_step']}  "
          f"restarts: {summary['restarts']}  "
          f"stragglers: {len(summary['stragglers'])}")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"pipeline: {stats['docs_in']} docs, {stats['rows_out']} rows, "
          f"mean doc fill {stats['mean_doc_fill']:.2%}, "
          f"packer shards {stats['active_shards']}")
    step_ms = sorted(1e3 * t for t in summary["step_times"])
    print(f"step time: p50 {step_ms[len(step_ms) // 2]:.1f} ms over {len(step_ms)} steps")
    print(f"kernel launches: packed attention forward {launches['packed_fwd']}, "
          f"backward {launches['packed_bwd']}")
    if steps >= 100:  # shorter runs sit inside the lr warmup
        assert losses[-1] < losses[0], "training did not reduce the loss"
    return {"losses": losses, "restarts": summary["restarts"],
            "final_step": summary["final_step"], "stragglers": summary["stragglers"],
            "step_times": summary["step_times"], "seconds": seconds,
            "pipeline": stats, "launches": launches,
            "loss_fell": losses[-1] < losses[0]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart demo)")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    train_stream(LM_100M, steps=args.steps, seq_len=args.seq_len,
                 batch_size=args.batch_size, ckpt_dir=args.ckpt_dir,
                 device=args.device, fail_at=args.fail_at)


if __name__ == "__main__":
    main()
