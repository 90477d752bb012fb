"""Fault-tolerance walkthrough on the PyTorch port: checkpoint/restart,
elastic resharding, worker failure in the streaming cluster, TTL requeue.

The port's counterpart of ``examples/fault_tolerance.py``, with its
arguments and its printout.  Four scenarios:

  1. training crash -> automatic restart from the latest async checkpoint
     (olmo-1b at smoke size; on the card each layer's attention is the
     packed-attention kernels, forward and backward, whose launches the
     scenario prints),
  2. elastic restore: the same checkpoint restored onto the current mesh
     (``make_local_mesh``: every rank on the data axis) as DTensors laid
     out by ``param_shardings``,
  3. a worker VM dying mid-stream: in-flight messages bounce back to the
     master queue (at-least-once) and the workload still completes -- on
     the discrete-event sim, the live asyncio runtime
     (``repro_torch.runtime.run_live``), or both (``--backend``),
  4. failed container placements TTL-requeueing through the container
     queue.

Scenarios 1 and 2 need the card unless given ``--device cpu``; 3 and 4
are numpy and asyncio.  The weights are drawn from a seeded generator
(not the JAX example's numbers); on the card the step computes in bf16,
which the packed kernels need, as on the CPU.

Usage:
  PYTHONPATH=src python examples/torch_fault_tolerance.py
  PYTHONPATH=src python examples/torch_fault_tolerance.py --backend live
  PYTHONPATH=src python examples/torch_fault_tolerance.py --backend both --smoke
  PYTHONPATH=src python examples/torch_fault_tolerance.py --device cpu

``--smoke`` runs only the streaming scenarios (3 and 4).
"""

import argparse
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import (
    AllocationQueue,
    ContainerQueue,
    HostRequest,
    SimConfig,
    simulate,
)
from repro_torch.scenarios import get_scenario


def _need_card(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass --device cpu to run the plain version on the CPU")


def scenario_1_crash_restart(tmp: str, device: str = "cuda",
                             params: Optional[Dict[str, Any]] = None,
                             compute_dtype: torch.dtype = torch.bfloat16
                             ) -> Dict[str, Any]:
    """olmo-1b at smoke size, 12 steps of 2 x 64-token batches, a failure
    injected at step 8 and a checkpoint every 5; the controller's summary
    and the packed kernels' launches.  ``params`` (fp32 on ``device``)
    replace the drawn weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.launch.train import make_params
    from repro_torch.models import build_model, make_batch
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.training.controller import TrainController, TrainControllerConfig

    print("=" * 64)
    print("1. Training crash -> restart from latest checkpoint")
    print("=" * 64)
    dev = torch.device(device)
    _need_card(dev)
    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    if params is None:
        params = make_params(model, 0, dev)
    step_fn = make_train_step(model, OptimizerConfig(), compute_dtype=compute_dtype)
    ctl = TrainController(step_fn, TrainControllerConfig(
        checkpoint_dir=tmp, checkpoint_every=5, async_checkpoint=True))

    def batches():
        i = 0
        while True:
            yield {k: v.to(dev) for k, v in make_batch(cfg, "train", 2, 64, seed=i).items()}
            i += 1

    fwd0, bwd0 = packed_ops.launches_fwd, packed_ops.launches_bwd
    _, _, summary = ctl.run(params, init_opt_state(params), batches(),
                            num_steps=12, fail_at=8)
    launches = {"packed_fwd": packed_ops.launches_fwd - fwd0,
                "packed_bwd": packed_ops.launches_bwd - bwd0}
    print(f"injected failure at step 8 -> restarts: {summary['restarts']}, "
          f"completed step {summary['final_step']} anyway")
    print(f"kernel launches: packed attention forward {launches['packed_fwd']}, "
          f"backward {launches['packed_bwd']}\n")
    return dict(summary, launches=launches)


def scenario_2_elastic_restore(tmp: str, device: str = "cuda") -> Dict[str, Any]:
    """A checkpoint of olmo-1b's smoke weights restored onto the current
    mesh; the mesh's shape and the first leaf's placements.  A process
    group the mesh started is ended after."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import make_params
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves

    print("=" * 64)
    print("2. Elastic restore onto the current mesh")
    print("=" * 64)
    dev = torch.device(device)
    _need_card(dev)
    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    specs = model.param_specs()
    params = make_params(model, 0, dev)
    mgr = CheckpointManager(tmp + "/elastic")
    mgr.save(1, {"p": params})

    started = not dist.is_initialized()
    try:
        mesh = make_local_mesh(dev.type)  # whatever topology this host has
        shape = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
        shardings = {"p": param_shardings(specs, mesh)}
        restored = mgr.restore(1, {"p": params}, shardings)
        leaf = tree_leaves(restored["p"])[0]
        same = all(torch.equal(a.full_tensor(), b) for a, b in
                   zip(tree_leaves(restored["p"]), tree_leaves(params)))
        print(f"restored onto mesh {shape}; "
              f"first leaf placements: {tuple(leaf.placements)}\n")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return {"mesh": shape, "placements": tuple(leaf.placements), "equal": same}


def scenario_3_worker_failure(backends: Sequence[str]) -> List[Dict[str, Any]]:
    """The microscopy stream (80 images) with worker 0 killed at t = 25 s,
    on each backend; each run's requeued, completed, total and makespan."""
    print("=" * 64)
    print("3. Worker VM failure mid-stream (messages requeued, run completes)")
    print("=" * 64)
    cfg = SimConfig(
        dt=0.5, cores_per_worker=4, max_workers=5,
        worker_boot_delay=5.0, pe_start_delay=1.0, t_max=1500.0,
        fail_worker_at=(0, 25.0),  # kill the busiest worker at t=25s
    )
    make_stream = get_scenario("microscopy").make_stream
    runs = []
    for backend in backends:
        stream = make_stream(0, n_images=80, duration_range=(4.0, 8.0))
        if backend == "live":
            from repro_torch.runtime import RuntimeConfig, run_live

            res = run_live(stream, cfg, runtime=RuntimeConfig(time_scale=0.01))
        else:
            res = simulate(stream, cfg)
        print(f"[{backend:>4}] worker 0 killed at t=25s; "
              f"{res.requeued} in-flight messages requeued at the head; "
              f"completed {res.completed}/{res.total} in {res.makespan:.0f}s")
        runs.append({"backend": backend, "requeued": res.requeued,
                     "completed": res.completed, "total": res.total,
                     "makespan": res.makespan})
    print()
    return runs


def scenario_4_ttl_requeue() -> Dict[str, Any]:
    """A placement that fails twice and starts on its third attempt; the
    TTL at each attempt and the requests dropped."""
    print("=" * 64)
    print("4. TTL requeue of failed placements (paper V-B.2)")
    print("=" * 64)
    cq, aq = ContainerQueue(), AllocationQueue()
    req = HostRequest("haste/cellprofiler:3.1.9", size_estimate=0.4, ttl=3,
                      target_worker=2)
    aq.push(req)
    attempts = []

    def try_start(r):
        attempts.append(r.ttl)
        return len(attempts) >= 3  # worker becomes ready on the 3rd try

    for _ in range(3):
        aq.consume(try_start=try_start, on_fail=cq.requeue)
        for r in cq.drain():
            r.target_worker = 2
            aq.push(r)
        if not len(aq):
            break
    print(f"placement attempts (ttl at attempt): {attempts} -> started")
    print(f"dropped requests: {len(cq.dropped)} (TTL never exhausted)\n")
    return {"attempts": attempts, "dropped": len(cq.dropped)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("sim", "live", "both"), default="sim",
                    help="streaming backend(s) for the worker-failure "
                    "scenario (default: sim)")
    ap.add_argument("--smoke", action="store_true",
                    help="streaming scenarios only (skip model training)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    backends = ("sim", "live") if args.backend == "both" else (args.backend,)

    if not args.smoke:
        _need_card(torch.device(args.device))
        with tempfile.TemporaryDirectory() as tmp:
            scenario_1_crash_restart(tmp, args.device)
            scenario_2_elastic_restore(tmp, args.device)
    scenario_3_worker_failure(backends)
    scenario_4_ttl_requeue()
    print("Done.")


if __name__ == "__main__":
    main()
