#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It needs nothing built beforehand and imports nothing of the JAX package.
Phases, in order; any failure raises and the script exits nonzero:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: the grouped-matmul kernel from ``csrc/`` with ``nvcc`` for
   ``sm_90a``;
3. the multiproc path: the port's ``run_live`` on the 40-image microscopy
   smoke stream, workers as forked OS processes each running the ``torch``
   payload on the card, once at the default payload size and once at full
   width, each held to the parity bands of the port's ``simulate``.  The
   workers send their kernel launch counts and per-message device ms back
   to the master, and each run's launches are summed from a count of 0.
   It runs in a child process: this one has touched CUDA, and forked
   workers of such a process cannot use it;
4. the kernel against its plain PyTorch version on the card, on the
   kernel test shapes, empty and ragged bins and both payload shapes, with
   the kernel's, the plain version's and ``torch.bmm``'s times beside the
   card's bound;
5. the slice at full size: ``run_live`` in-process on the full 767-image
   microscopy stream, one grouped matmul of ``qwen3-moe-30b-a3b`` width per
   message (128 experts, 128-row bins, d = f = 2048, f32), with the
   kernel's launch count reset before the run and read after it.  Its
   final worker target is held to that of a witness run of the ``sleep``
   payload on the same stream and scale, made just before it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MP_FLAG = "--multiproc-phase"  # runs phase 3 in this child interpreter

# the bands of tests/test_backend_parity.py for the microscopy scenario
UTIL_TOL, TARGET_TOL, MAKESPAN_RATIO = 0.15, 2, 1.6
PAYLOAD_FULL = {"experts": 128, "rows": 128, "dim": 2048}
# the multiproc runs: (name, payload kwargs, wall seconds per scenario
# second).  Each forked worker builds its payload (and initialises CUDA and
# loads the kernel) while its 15 s boot delay runs, so the delay must cover
# that in wall time: under a second at the default size, and about 12 s of
# seeded draws for the full-width weights.
MP_RUNS = (("default", {}, 0.2), ("full", PAYLOAD_FULL, 2.0))
# the full-size in-process run (peak ~55 msgs/s); the card must stay at
# most this busy over it, so that its time fits inside the scaled messages
FULL_TIME_SCALE, MAX_DEVICE_BUSY = 0.05, 0.4

# H100 SXM data sheet, dense: fp32 on the CUDA cores, bf16 on the tensor
# cores, device-memory bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _assert_parity(sim, live, live_targets, final_ref, what):
    """The bands of ``tests/test_backend_parity.py::_assert_parity``.

    The final worker target is held to ``final_ref = (who, targets)``: the
    simulator's on the smoke stream; on the full stream, a live run of the
    ``sleep`` payload on the same stream and scale.  There the final target
    is a drain transient of the live runtime, whatever its payload: in its
    last ticks the target drops below where the simulator's ends.
    """
    ref_who, ref_targets = final_ref
    ref_final, live_final = int(ref_targets[-1]), int(live_targets[-1])
    checks = {
        "live completes >= 90%": live["completed"] >= 0.9 * live["total"],
        "sim completes >= 90%": sim["completed"] >= 0.9 * sim["total"],
        "utilization within 0.15": abs(
            live["mean_scheduled_utilization_active"]
            - sim["mean_scheduled_utilization_active"]) <= UTIL_TOL,
        "max target within 2": abs(
            live["max_target_workers"] - sim["max_target_workers"]
        ) <= TARGET_TOL,
        f"final target within 2 of the {ref_who}'s":
            abs(live_final - ref_final) <= TARGET_TOL,
        "makespan within 1.6x": (
            sim["makespan_s"] / MAKESPAN_RATIO
            <= live["makespan_s"]
            <= MAKESPAN_RATIO * sim["makespan_s"]),
    }
    keys = ("completed", "total", "makespan_s",
            "mean_scheduled_utilization_active", "max_target_workers")
    for who, summary in (("sim ", sim), ("live", live)):
        print(f"[{what}] {who} {json.dumps({k: summary[k] for k in keys})}")
    print(f"[{what}] final target: live {live_final}, {ref_who} {ref_final}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: outside the parity bands: {bad}")


def _microscopy(smoke: bool):
    """(stream, SimConfig, first-fit IRMConfig) factories for microscopy."""
    from repro_torch.scenarios.registry import get_scenario

    scn = get_scenario("microscopy")
    overrides = scn.smoke_overrides if smoke else {}

    def stream():
        return scn.make_stream(0, **overrides)

    def sim_config():
        cfg = scn.sim_config()
        if smoke:
            cfg.t_max = scn.smoke_t_max
        return cfg

    def irm_config():
        ic = scn.irm_config()
        ic.allocator.algorithm = "first-fit"
        return ic

    return stream, sim_config, irm_config


def _simulate(stream, sim_config, irm_config):
    from repro_torch.core.irm import IRM
    from repro_torch.core.sim import simulate
    from repro_torch.scenarios.engine import summarize_result

    cfg = sim_config()
    res = simulate(stream(), cfg, irm=IRM(irm_config()))
    return summarize_result(res, cfg.dt), res.target_workers


def multiproc_phase() -> None:
    """Phase 3, in a child process that never touches CUDA itself."""
    import numpy as np

    from repro_torch.core.irm import IRM
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.runtime import RuntimeConfig, run_live
    from repro_torch.scenarios.engine import summarize_result

    stream, sim_config, irm_config = _microscopy(smoke=True)
    sim, sim_targets = _simulate(stream, sim_config, irm_config)
    for size, kwargs, scale in MP_RUNS:
        what = f"multiproc {size}"
        cfg = sim_config()
        stats: dict = {}
        ops.launches = 0  # the forked workers start from this count
        res = run_live(
            stream(), cfg, irm=IRM(irm_config()),
            runtime=RuntimeConfig(time_scale=scale, payload="torch",
                                  payload_kwargs=dict(kwargs),
                                  transport="multiproc"),
            stats=stats,
        )
        live = summarize_result(res, cfg.dt)
        launches = stats["transport"]["payload_kernel_launches"]
        dev_ms = np.array(stats["payload_device_ms"])
        if not res.completed == res.total == 40:
            raise AssertionError(f"{what}: {res.completed}/{res.total} completed")
        if launches < res.completed:
            raise AssertionError(
                f"{what}: {launches} kernel launches for {res.completed} messages")
        if len(dev_ms) != res.completed or not (dev_ms > 0).all():
            raise AssertionError(
                f"{what}: {len(dev_ms)} device times for {res.completed} messages")
        _assert_parity(sim, live, res.target_workers, ("sim", sim_targets), what)
        print(json.dumps({"multiproc": {
            "payload": size, "completed": int(res.completed),
            "total": int(res.total), "launches": int(launches),
            "time_scale": scale, "wall_s": stats["wall_s"],
            "msgs_per_s": stats["messages_per_s"],
            "device_ms_mean": float(dev_ms.mean()),
            "device_ms_p99": float(np.percentile(dev_ms, 99)),
            "workers_spawned": stats["transport"]["workers_spawned"],
        }}))


def _time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(x, w, gs):
    """(bound ms, what bounds it): the work these bins need, counted once."""
    E, C, d = x.shape
    f = w.shape[2]
    g = gs.clamp(0, C).cpu().tolist()
    flops = 2.0 * sum(g) * d * f
    item = x.element_size()
    nbytes = (sum(g) * d + sum(1 for v in g if v > 0) * d * f
              + E * C * f) * item + 4 * E
    dtype = str(x.dtype).replace("torch.", "")
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_phase(torch, np):
    """Phase 4: the kernel against its plain version; returns the payload
    shape's record for the kernels line."""
    from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, E, C, d, f, dtype, group sizes or None for random, rtol, atol)
    # f32 2e-4 and bf16 (5e-2, 5e-1) are tests/test_kernels.py's own.  At the
    # full payload shape both versions sum 2048 fp32 products of unit normals
    # in different orders: each output's rounding error is about
    # u*sqrt(d)*|out| ~ 6e-8*45*45 ~ 1.2e-4, and the largest of 33.5M outputs
    # stays near 1e-3, so atol 1e-2 leaves a 10x margin and still catches
    # any wrong tile (errors of order |out| ~ 45).
    cases = []
    for E, C, d, f in ((4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64)):
        cases.append((f"test {E}x{C}x{d}x{f} f32", E, C, d, f, f32, None, 2e-4, 2e-4))
        cases.append((f"test {E}x{C}x{d}x{f} bf16", E, C, d, f, bf16, None, 5e-2, 5e-1))
    cases += [
        ("empty bins gs=[0,0,64,0]", 4, 128, 64, 64, f32, [0, 0, 64, 0], 2e-4, 2e-4),
        ("ragged 3x100x70x90 f32", 3, 100, 70, 90, f32, [0, 37, 100], 2e-4, 2e-4),
        ("ragged 3x100x70x90 bf16", 3, 100, 70, 90, bf16, [0, 37, 100], 5e-2, 5e-1),
        ("payload default 4x64x64x64", 4, 64, 64, 64, f32, [64] * 4, 2e-4, 2e-4),
    ]
    rng = np.random.default_rng(0)
    for name, E, C, d, f, dtype, sizes, rtol, atol in cases:
        gs_np = (rng.integers(0, C + 1, size=E) if sizes is None
                 else np.asarray(sizes))
        x_np = rng.normal(size=(E, C, d)) * (
            np.arange(C)[None, :] < gs_np[:, None])[..., None]
        x = torch.tensor(x_np, device=dev).to(dtype)
        w = torch.tensor(rng.normal(size=(E, d, f)), device=dev).to(dtype)
        gs = torch.tensor(gs_np, dtype=torch.int32, device=dev)
        out = grouped_matmul(x, w, gs)
        ref = grouped_matmul_ref(x, w, gs)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pad = torch.arange(C, device=dev)[None, :] >= gs[:, None]
        pad_max = out.float().abs()[pad].max().item() if pad.any() else 0.0
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
        print(f"[kernel] {name}: max_abs_err={err:.3e} (rtol={rtol}, "
              f"atol={atol}) padding_max={pad_max} {'ok' if ok else 'MISMATCH'}")
        if not ok or pad_max != 0.0:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")

    # the full payload shape, data made on the card from a seed
    E, C, d = PAYLOAD_FULL["experts"], PAYLOAD_FULL["rows"], PAYLOAD_FULL["dim"]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((E, C, d), generator=gen, device=dev)
    w = torch.randn((E, d, d), generator=gen, device=dev)
    gs = torch.full((E,), C, dtype=torch.int32, device=dev)
    out = grouped_matmul(x, w, gs)
    ref = grouped_matmul_ref(x, w, gs)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print(f"[kernel] payload full {E}x{C}x{d}x{d} f32: max_abs_err={err:.3e} "
          f"(atol=1e-2)")
    if not err <= 1e-2:
        raise AssertionError(f"kernel disagrees at the payload shape: {err}")
    del out, ref
    valid = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]

    def library():
        return torch.bmm(x, w).masked_fill_(~valid, 0.0)

    iters = 20
    ms = _time_ms(torch, lambda: grouped_matmul(x, w, gs), iters)
    plain_ms = _time_ms(torch, lambda: grouped_matmul_ref(x, w, gs), iters)
    library_ms = _time_ms(torch, library, iters)
    ms_again = _time_ms(torch, lambda: grouped_matmul(x, w, gs), iters)
    bound_ms, bound_by = _bound(x, w, gs)
    flops = 2.0 * E * C * d * d
    print(f"[kernel] payload full: kernel {ms:.4f} ms (again {ms_again:.4f}), "
          f"plain {plain_ms:.4f} ms, torch.bmm+mask {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); kernel "
          f"{flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.3f} of bound")
    del x, w
    torch.cuda.empty_cache()
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def full_phase(torch, np):
    """Phase 5: the full microscopy stream in-process; returns launches."""
    from repro_torch.core.irm import IRM
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.runtime import RuntimeConfig, run_live
    from repro_torch.scenarios.engine import summarize_result

    stream, sim_config, irm_config = _microscopy(smoke=False)
    sim, sim_targets = _simulate(stream, sim_config, irm_config)
    witness = run_live(
        stream(), sim_config(), irm=IRM(irm_config()),
        runtime=RuntimeConfig(time_scale=FULL_TIME_SCALE, payload="sleep"),
    )
    print(f"[full] time_scale={FULL_TIME_SCALE}; sleep witness: "
          f"{witness.completed}/{witness.total} completed, final target "
          f"{int(witness.target_workers[-1])}")

    cfg = sim_config()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    ops.launches = 0
    res = run_live(
        stream(), cfg, irm=IRM(irm_config()),
        runtime=RuntimeConfig(time_scale=FULL_TIME_SCALE, payload="torch",
                              payload_kwargs=dict(PAYLOAD_FULL)),
        stats=stats,
    )
    launches = ops.launches
    peak_mem = torch.cuda.max_memory_allocated()
    live = summarize_result(res, cfg.dt)
    if not res.completed == res.total == 767:
        raise AssertionError(f"full: {res.completed}/{res.total} completed")
    if launches < res.completed:
        raise AssertionError(
            f"full: {launches} kernel launches for {res.completed} messages")
    _assert_parity(sim, live, res.target_workers,
                   ("sleep witness", witness.target_workers), "full")
    lat = np.array([m.done_t - m.arrival for m in res.messages])
    dev_ms = np.array(stats["payload_device_ms"])
    busy = float(dev_ms.sum() / 1e3 / stats["wall_s"])
    print("[full] " + json.dumps({
        "completed": int(res.completed), "launches": launches,
        "time_scale": FULL_TIME_SCALE, "wall_s": stats["wall_s"],
        "msgs_per_s": stats["messages_per_s"],
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "latency_p50_wall_s": float(np.percentile(lat, 50)) * FULL_TIME_SCALE,
        "latency_p99_wall_s": float(np.percentile(lat, 99)) * FULL_TIME_SCALE,
        "device_ms_mean": float(dev_ms.mean()),
        "device_ms_p99": float(np.percentile(dev_ms, 99)),
        "device_busy_share": busy,
        "peak_device_mem_gib": peak_mem / 2**30,
        "irm_step_ms_p99": stats["irm_step_ms_p99"],
    }))
    if not busy <= MAX_DEVICE_BUSY:
        raise AssertionError(
            f"full: the card was {busy:.3f} busy, over {MAX_DEVICE_BUSY}")
    return launches


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        _fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == [MP_FLAG]:
        multiproc_phase()
        return
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. the build
    from repro_torch.kernels.grouped_matmul import kernel

    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"[build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    # 3. the multiproc path, in a child process
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), MP_FLAG],
        capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(child.stdout)
    sys.stderr.write(child.stderr[-4000:])
    if child.returncode != 0:
        raise RuntimeError(f"multiproc phase failed ({child.returncode})")
    mp_runs = [json.loads(line)["multiproc"]
               for line in child.stdout.splitlines()
               if line.startswith('{"multiproc"')]
    if [r["payload"] for r in mp_runs] != [size for size, _, _ in MP_RUNS]:
        raise RuntimeError(f"multiproc phase reported {mp_runs}")
    print(f"[multiproc] phase took {time.perf_counter() - t0:.1f} s")

    # 4. the kernel against its plain version
    record = kernel_phase(torch, np)

    # 5. the slice at full size
    launches = full_phase(torch, np)

    print(json.dumps({"kernels": [{
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/kernel.py:31",
        "launches": launches,
        "launches_by_path": {
            **{f"multiproc {r['payload']}": r["launches"] for r in mp_runs},
            "inproc full": launches,
        },
        **record,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
