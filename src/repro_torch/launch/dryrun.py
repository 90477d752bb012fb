"""Multi-pod dry-run: every (arch x shape x mesh) cell's step on stand-ins,
counted per device: the counterpart of ``repro/launch/dryrun.py``.

Parameters, optimizer state, inputs and the cache are meta tensors (shapes
and dtypes, nothing allocated), placed on the production mesh as DTensors
with the production shardings (``distributed/sharding.py``) over a
``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks that
``main`` starts and ends itself.  The step runs once under
``trace_analysis.analyze_step``, which counts what one device dispatches:
FLOPs, product bytes, collective wire bytes, every op's traffic and the
peak of the live bytes.  Only a tensor that lies on the CPU takes a
kernel's plain version, so the meta stand-ins take the kernel route, as
the card does: the kernels' operators (``kernels/custom_ops.py``) count
their own work and allocate only their outputs.  (Fake ``cuda`` tensors
would take the same route, but a CPU-only build of PyTorch cannot index
them from Python.)  Decode cells serve from the port's paged cache, its
pools sharded by page (``cache_specs``, ``decode_attention_distributed``);
prefill cells fill an empty one, each rank writing its rows' K/V into the
pages it holds (``layers.write_rows_local``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ARCH_NAMES, SHAPES_BY_NAME, cells_for, get_config
from ..distributed.context import activation_sharding
from ..distributed.sharding import (
    batch_shardings,
    cache_shardings,
    make_rules,
    param_shardings,
)
from ..models import abstract_params, build_model, cache_specs, input_specs
from ..models.params import tree_bytes, tree_map
from ..training import OptimizerConfig, make_train_step
from .analysis import HW, HW_NAME, NODE_GPUS, cost_summary, memory_summary
from .mesh import make_production_mesh
from .trace_analysis import analyze_step

__all__ = ["lower_cell", "roofline_terms", "fake_process_group", "main"]


def fake_process_group(world: int) -> None:
    """Start a ``fake`` process group of ``world`` ranks in this process
    (rank 0), ending any group that runs: it lays DTensors out on every
    rank and moves no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _placed(t: torch.Tensor, sharding: Any) -> torch.Tensor:
    """A meta stand-in laid out by ``sharding``: a DTensor over this rank's
    even shard, made with ``from_local`` (nothing is scattered)."""
    if sharding is None:
        return t
    mesh, placements = sharding.mesh, sharding.placements
    shape = list(t.shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] //= mesh.size(m)
    local = torch.empty(shape, dtype=t.dtype, device=t.device)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _place_cache(cache: Any, shardings: Any) -> Any:
    if isinstance(cache, dict):
        return {k: _place_cache(v, shardings[k]) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_place_cache(v, s) for v, s in zip(cache, shardings))
    return _placed(cache, shardings) if isinstance(cache, torch.Tensor) else cache


def _cache_bytes(cache: Any) -> int:
    if isinstance(cache, dict):
        return sum(_cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(_cache_bytes(v) for v in cache)
    return cache.numel() * cache.element_size() if isinstance(cache, torch.Tensor) else 0


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    remat_policy: str = "nothing",
    microbatches: int = 1,
    param_dtype: torch.dtype = torch.float32,
    keep_hlo: bool = False,
    layout: str = "tp",
    mesh: Any = None,
    shape: Any = None,
    top_held: int = 0,
) -> Dict[str, Any]:
    """Run one cell's step on stand-ins; return the roofline record.

    ``mesh`` (default: the production mesh, which needs a process group of
    its ranks) and ``shape`` (default: ``SHAPES_BY_NAME[shape_name]``) let a
    caller count a step of its own on another mesh, such as the one-card
    (1, 1) mesh.  ``keep_hlo`` keeps the count itself (``_cost``), the
    port's counterpart of the HLO text; ``top_held`` (debug, off by default)
    lists in it the largest storages held at the peak.
    """
    cfg = get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    model = build_model(cfg)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type="cuda")
    rules = make_rules(mesh, layout)
    n_chips = mesh.size()

    specs = model.param_specs()
    p_shard = param_shardings(specs, mesh, rules)
    batch = input_specs(cfg, shape)
    b_shard = batch_shardings(batch, mesh, rules, decode=(shape.kind == "decode"))
    dbatch = {k: _placed(v, b_shard[k]) for k, v in batch.items()}

    def placed_params(dtype: Optional[torch.dtype]) -> Any:
        return tree_map(_placed, abstract_params(specs, dtype), p_shard)

    t0 = time.time()
    if shape.kind == "train":
        params = placed_params(None)  # fp32 masters
        opt_state = {"m": placed_params(torch.float32), "v": placed_params(torch.float32),
                     "step": torch.empty((), dtype=torch.int32, device="meta")}
        step_fn = make_train_step(model, OptimizerConfig(), remat_policy=remat_policy,
                                  microbatches=microbatches, grad_shardings=p_shard)
        args = (params, opt_state, dbatch)
    else:  # serving: prefill fills an empty paged cache, decode extends a full one
        cache = cache_specs(cfg, shape)
        dcache = _place_cache(cache, cache_shardings(cache, mesh, rules))
        step_fn = model.prefill if shape.kind == "prefill" else model.decode_step
        args = (placed_params(torch.bfloat16), dbatch, dcache)

    pod = NODE_GPUS if n_chips > 1 else 10**9
    with activation_sharding(mesh, rules), implicit_replication():
        _, cost = analyze_step(step_fn, *args, pod_size=pod, mesh=mesh, top_held=top_held)
    count_s = time.time() - t0

    total_params, active_params = cfg.param_counts()
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": "x".join(str(mesh.size(i)) for i in range(mesh.ndim)),
        "chips": int(n_chips),
        "hw": HW_NAME,
        "compile_seconds": round(count_s, 1),
        "param_count": total_params,
        "active_param_count": active_params,
        "param_bytes_global": tree_bytes(abstract_params(specs, param_dtype)),
        "memory": memory_summary(cost),
        "eager_cost": cost_summary(cost),
        "flops_per_dev": cost.flops,
        "dot_bytes_per_dev": cost.dot_bytes,
        "collectives": dict(cost.coll, total=cost.coll_bytes, ici=cost.ici_bytes,
                            dcn=cost.dcn_bytes, count=cost.coll_count),
        "remat_policy": remat_policy,
        "microbatches": microbatches,
        "layout": layout,
    }
    if shape.kind != "train":
        record["cache_bytes_global"] = _cache_bytes(cache)
    record.update(roofline_terms(record, shape))
    if keep_hlo:
        record["_cost"] = cost
    return record


def roofline_terms(record: Dict[str, Any], shape: Any) -> Dict[str, Any]:
    """Three roofline terms (seconds per step, per device), the JAX
    package's formulas on the card's figures (``HW``).

    FLOPs and product bytes come from the dispatch count.  The memory term
    takes the larger of the product bytes and the eager traffic (the JAX
    package takes XLA's bytes accessed there).  The collective term adds
    the NVLink and the network times.
    """
    flops = record["flops_per_dev"]
    bytes_acc = max(record["dot_bytes_per_dev"], record["eager_cost"]["eager_bytes"])
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = bytes_acc / HW["hbm_bw"]
    t_collective = (record["collectives"]["ici"] / HW["ici_bw"]
                    + record["collectives"]["dcn"] / HW["dcn_bw"])
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    # MODEL_FLOPS: 6*N*D for training, 2*N*D for inference (per step, global)
    n_active = record["active_param_count"]
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    # enc-dec (seamless): S is split S/2 encoder + S/2 decoder and each
    # half only passes through its own stack -- 6*N_total*(S/2) overall
    if get_config(record["arch"]).encdec and shape.kind in ("train", "prefill"):
        tokens //= 2
    mult = 6 if shape.kind == "train" else 2
    model_flops_global = mult * n_active * tokens
    model_flops_per_chip = model_flops_global / record["chips"]
    useful = model_flops_per_chip / flops if flops else 0.0
    bound = max(t_compute, t_memory, t_collective)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "model_flops_global": model_flops_global,
        "useful_flops_fraction": useful,
        "roofline_step_s": bound,
        "model_flops_util": (
            model_flops_per_chip / HW["peak_flops_bf16"] / bound if bound else 0.0),
    }


def run_cells(cells, meshes, **kw) -> list:
    """Each (arch, shape) on each mesh (False: 16x16, True: 2x16x16), each
    in a fake process group of its ranks; the records, an ``error`` in
    place of a cell that raised."""
    results = []
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
            fake_process_group(512 if mp else 256)
            try:
                rec = lower_cell(arch, shape_name, multi_pod=mp, **kw)
                results.append(rec)
                print(
                    f"[OK] {tag}: compile={rec['compile_seconds']}s "
                    f"hbm/dev={rec['memory']['total_hbm_bytes']/1e9:.2f}GB "
                    f"flops/dev={rec['flops_per_dev']:.3e} "
                    f"coll/dev={rec['collectives']['total']/1e6:.1f}MB "
                    f"dominant={rec['dominant']} "
                    f"useful={rec['useful_flops_fraction']:.2f} "
                    f"mfu_bound={rec['model_flops_util']:.3f}",
                    flush=True,
                )
            except Exception as e:  # a failure here is a bug in the system
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": "2x16x16" if mp else "16x16",
                                "error": f"{type(e).__name__}: {e}"})
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
            finally:
                dist.destroy_process_group()
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape filter for --all or --arch")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "serve"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.all:
        keep = set(args.shapes.split(",")) if args.shapes else None
        cells = [(arch, shape.name) for arch in ARCH_NAMES
                 for shape in cells_for(get_config(arch))
                 if not keep or shape.name in keep]
    elif args.arch and (args.shape or args.shapes):
        names = [args.shape] if args.shape else args.shapes.split(",")
        cells = [(args.arch, name) for name in names]
    else:
        ap.error("--arch and --shape (or --shapes) required unless --all")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    results = run_cells(cells, meshes, remat_policy=args.remat,
                        microbatches=args.microbatches, layout=args.layout)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")

    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} cells OK")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
