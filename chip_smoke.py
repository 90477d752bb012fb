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

6. the paged-decode-attention kernel against its plain version on the
   card at the serving run's decode shape (8 sequences of ragged lengths in
   64-1056 and one of 0, 32 query over 8 KV heads of 128, 16-token pages in
   a 1024-page pool, one -1 table entry inside a live range, NaN in every
   unreferenced page), f32 and bf16, with the kernel's, the plain
   version's and ``scaled_dot_product_attention``'s times beside the bound;
   ``scaled_dot_product_attention`` is also timed, causal, at the prefill
   shape, as the yardstick of the packed-attention kernel still to port;
7. the serving entry point: ``launch.serve.run_local`` on ``qwen3-8b`` at
   full width and depth in bf16 (weights drawn on the card from a seed), 8
   prompts and 16 decode steps over a 1024-page First-Fit paged cache,
   with the kernel's launches held to 36 layers x 16 steps;
8. ragged serving: 8 prompts of 64-1024 tokens through ``prefill`` and 32
   paged decode steps (launches held to 36 x 32), the First-Fit watermark,
   and the first decode step's logits held to the port's own prefill of
   prompt + token.

Each phase prints its wall time; a failing phase raises with its name.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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

# the paged kernel at the serving run's decode shape: 8 sequences, qwen3-8b's
# 32 query heads over 8 KV heads of 128, 16-token pages, a 1024-page pool
DECODE = {"B": 8, "H": 32, "KVH": 8, "D": 128, "page_size": 16,
          "num_pages": 1024, "max_pages": 128}
PAGED_TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # test_kernels TOLS
PREFILL = {"B": 8, "S": 1024, "H": 32, "KVH": 8, "D": 128}  # the serving prefill
SERVE_ARGV = ["--backend", "local", "--arch", "qwen3-8b", "--requests", "8",
              "--gen-tokens", "16", "--pages", "1024"]
RAGGED_STEPS = 32
PROFILE_STEPS = 2  # decode steps under torch.profiler, after the timed ones
# The first paged decode step against the port's prefill of prompt + token,
# both bf16 at full width: max |dlogit| <= FIRST_STEP_TOL * max |logit|.
# bf16 keeps 8 significant bits; the two paths round at different places
# (GEMMs of 1 row against S+1 rows, fp32 p in the kernel against bf16 p in
# the flash prefill) in each of 36 layers.  On the CPU, at qwen3-8b's
# attention shape and full depth with a narrowed MLP, the gap measured 0.72%
# of max |logit|, and 0.0065 relative in l2; 5% leaves about 7x.  Losing the
# generated tokens' K/V, the JAX package's prefill-to-decode fault, moves
# the logits by 23% of max |logit| at its smoke size.
FIRST_STEP_TOL = 0.05
L2_FLUSH_BYTES = 256 << 20  # over the 50 MB L2: each timed launch finds it cold


@contextlib.contextmanager
def _phase(name: str):
    """Print the phase's wall time; re-raise a failure with its name."""
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
              f"{type(e).__name__}: {e}", flush=True)
        raise RuntimeError(f"phase {name!r} failed: {type(e).__name__}: {e}") from e
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


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


def _time_ms(torch, fn, reps: int, flush) -> float:
    """Median over ``reps`` of one call timed by CUDA events, each call made
    after ``flush`` has evicted the L2 cache (outside the events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


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

    reps = 20
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ms = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
    plain_ms = _time_ms(torch, lambda: grouped_matmul_ref(x, w, gs), reps, flush)
    library_ms = _time_ms(torch, library, reps, flush)
    ms_again = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
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


def _decode_inputs(torch, np, dtype):
    """The decode-shape inputs: ragged lengths in 64-1056 and one of 0,
    pages dealt from a permutation of pages 1..P-1, one -1 inside a live
    range (it reads page 0), and NaN in every page no entry refers to."""
    dev = torch.device("cuda")
    B, H, KVH, D = DECODE["B"], DECODE["H"], DECODE["KVH"], DECODE["D"]
    ps, P, maxp = DECODE["page_size"], DECODE["num_pages"], DECODE["max_pages"]
    rng = np.random.default_rng(13)
    lens = rng.integers(64, 1057, size=B)
    lens[3] = 0
    perm = rng.permutation(np.arange(1, P))
    table = np.full((B, maxp), -1, np.int32)
    off = 0
    for b, n in enumerate(-(-lens // ps)):
        table[b, :n] = perm[off:off + n]
        off += n
    hole = int(np.argmax(lens))
    table[hole, 1] = -1
    referenced = set(table[table >= 0].tolist()) | {0}
    unreferenced = [p for p in range(P) if p not in referenced]
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    k_pool = torch.randn((P, ps, KVH, D), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((P, ps, KVH, D), generator=gen, device=dev).to(dtype)
    k_pool[unreferenced] = float("nan")
    v_pool[unreferenced] = float("nan")
    return (q, k_pool, v_pool, torch.tensor(table, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)), lens


def paged_kernel_phase(torch, np):
    """Phase 6: the paged kernel against its plain version at the decode
    shape; returns its record for the kernels line and the prefill
    yardstick of the packed-attention kernel still to port."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import (
        gather_pages,
        paged_attention_ref,
    )
    from repro_torch.models.layers import flash_attention

    dev = torch.device("cuda")
    record = None
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        args, lens = _decode_inputs(torch, np, dtype)
        out = paged_decode_attention(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        rtol, atol = PAGED_TOLS[name]
        err = (out.float() - ref.float()).abs().max().item()
        zero_row = int(np.flatnonzero(lens == 0)[0])
        checks = {
            "within TOLS": torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol),
            "finite": bool(torch.isfinite(out).all()),
            "length-0 row is 0": bool((out[zero_row] == 0).all()),
        }
        print(f"[paged] {name}: lens={lens.tolist()} max_abs_err={err:.3e} "
              f"(rtol={rtol}, atol={atol}) {checks}")
        if not all(checks.values()):
            raise AssertionError(f"paged kernel disagrees with its plain version "
                                 f"in {name}: {checks}")
        if name != "bfloat16":
            continue
        # the serving dtype: times, bound and library yardstick
        q, k_pool, v_pool, table, lens_t = args
        B, H, D = q.shape
        KVH = k_pool.shape[2]
        n_live = -(-int(lens.max()) // DECODE["page_size"])
        k_d = gather_pages(k_pool, table[:, :n_live]).transpose(1, 2).contiguous()
        v_d = gather_pages(v_pool, table[:, :n_live]).transpose(1, 2).contiguous()
        mask = (torch.arange(k_d.shape[2], device=dev)[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, k_d, v_d, attn_mask=mask,
                                                  enable_gqa=True)

        reps = 50
        ms = _time_ms(torch, lambda: paged_decode_attention(*args), reps, flush)
        plain_ms = _time_ms(torch, lambda: paged_attention_ref(*args), reps, flush)
        library_ms = _time_ms(torch, library, reps, flush)
        ms_again = _time_ms(torch, lambda: paged_decode_attention(*args), reps, flush)
        item, tokens = q.element_size(), int(lens.sum())
        nbytes = (2 * tokens * KVH * D + 2 * B * H * D) * item + table.numel() * 4 + B * 4
        flops = 4.0 * tokens * H * D
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[name]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[paged] bf16 at the decode shape: kernel {ms:.4f} ms (again "
              f"{ms_again:.4f}), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB of "
              f"live K/V, q, out, table; {flops / 1e9:.3f} GFLOP); kernel at "
              f"{bound_ms / ms:.3f} of the bound, {nbytes / ms / 1e6:.1f} GB/s")
        record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
        del k_d, v_d

    # the yardstick of packed_flash_attention (ROADMAP queue 2 item 2) at the
    # serving prefill shape: causal sdpa, and the port's plain flash path
    B, S, H, KVH, D = (PREFILL[k] for k in ("B", "S", "H", "KVH", "D"))
    gen = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, KVH, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KVH, D), generator=gen, device=dev).to(torch.bfloat16)
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    flash_ms = _time_ms(torch, lambda: flash_attention(q, k, v, seg, seg), 5, flush)
    flops = 4.0 * B * H * D * S * (S + 1) / 2  # the causal half, diagonal included
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 2 * B * S * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]
    yardstick = {
        "name": "packed_flash_attention (to port)", "shape": PREFILL,
        "library_ms": sdpa_ms, "plain_ms": flash_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    print(f"[paged] prefill yardstick: {json.dumps(yardstick)}")
    del flush
    torch.cuda.empty_cache()
    return record, yardstick


def serve_phase(torch):
    """Phase 7: the serving entry point at full width; returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve

    cfg = get_config("qwen3-8b")
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    stats = serve.run_local(serve.parse_args(SERVE_ARGV))
    launches = ops.launches
    want = cfg.n_layers * stats["gen_tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("[serve] " + json.dumps({
        "launches": launches, "prefill_s": stats["prefill_s"],
        "decode_ms_per_step": stats["decode_s"] / stats["gen_tokens"] * 1e3,
        "tokens_per_s": stats["sequences"] * stats["gen_tokens"] / stats["seconds"],
        "peak_device_mem_gib": peak, "pages_used": stats["pages_used"],
    }))
    if launches != want:
        raise AssertionError(f"{launches} paged-kernel launches, want {want}")
    if not stats["logits_finite"] or stats["tokens"].shape != (8, 17):
        raise AssertionError(f"bad output: finite={stats['logits_finite']}, "
                             f"tokens {tuple(stats['tokens'].shape)}")
    torch.cuda.empty_cache()
    return launches


def _profile_decode(torch, model, params, tok, cache, step_wall_ms):
    """Device time of PROFILE_STEPS more decode steps by kernel, from
    ``torch.profiler``, against the unprofiled wall time of a step."""
    from repro_torch.launch import serve
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            logits, cache = model.decode_step(params, {"tokens": tok}, cache)
            tok = serve.greedy(logits)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / PROFILE_STEPS, e.count / PROFILE_STEPS, e.key))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    paged = [(ms, n) for ms, n, key in kernels if "paged_attn_kernel" in key]
    return {
        "device_ms_per_step": device_ms,
        "wall_ms_per_step": step_wall_ms,
        "device_busy_share": device_ms / step_wall_ms,
        "kernel_launches_per_step": sum(n for _, n, _ in kernels),
        "paged_kernel_ms_per_step": paged[0][0] if paged else 0.0,
        "paged_kernel_launches_per_step": paged[0][1] if paged else 0,
        "top_kernels_ms_per_step": [[key[:60], ms] for ms, _, key in kernels[:6]],
    }


def ragged_phase(torch, np):
    """Phase 8: ragged prompts through prefill and paged decode at full
    width; returns the decode launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.make_params(model, 0, dev)
    torch.cuda.synchronize()
    print(f"[ragged] weights drawn on the card in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(21)
    B = 8
    lens = rng.integers(64, 1025, size=B)
    S = int(lens.max())
    tokens = np.zeros((B, S + 1), np.int32)
    seg = np.zeros((B, S + 1), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab_size, size=n)
        seg[b, :n] = 1
    positions = torch.arange(S + 1, dtype=torch.int32, device=dev).expand(B, S + 1)

    def batch(width):
        return {"tokens": torch.tensor(tokens[:, :width], device=dev),
                "segment_ids": torch.tensor(seg[:, :width], device=dev),
                "positions": positions[:, :width]}

    def new_cache():
        return model.init_paged_cache(serve.paged_layout(cfg, 1024), serve.DTYPE, dev)

    cache = new_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch(S), cache)
    tok = serve.greedy(logits)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    ops.launches = 0
    finite = torch.isfinite(logits).all()
    first = None
    step_ms = []
    for i in range(RAGGED_STEPS):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        if i == 0:
            first, tok0 = logits.clone(), tok.clone()
        finite &= torch.isfinite(logits).all()
        tok = serve.greedy(logits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launches
    alloc = cache["alloc"]
    layout = alloc.layout
    watermark, used = alloc.highest_used_page(), alloc.used_pages
    need = sum(layout.pages_for(int(n) + RAGGED_STEPS) for n in lens)
    profile = _profile_decode(torch, model, params, tok, cache,
                              sum(step_ms) / RAGGED_STEPS)
    del cache

    # the port's own prefill of prompt + first generated token
    for b, n in enumerate(lens):
        tokens[b, n] = int(tok0[b, 0])
        seg[b, n] = 1
    ref, _ = model.prefill(params, batch(S + 1), new_cache())
    delta = (first - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((first - ref).norm() / ref.norm()).item()
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = sum(step_ms) / 1e3
    print("[ragged] " + json.dumps({
        "prompt_lens": lens.tolist(), "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_s * 1e3 / RAGGED_STEPS,
        "decode_ms_p50": sorted(step_ms)[RAGGED_STEPS // 2],
        "tokens_per_s": B * RAGGED_STEPS / decode_s,
        "launches": launches, "watermark": watermark, "pages_used": used,
        "pages_needed": need, "utilization": alloc.utilization(),
        "first_step_max_abs_dlogit": delta, "max_abs_logit": scale,
        "first_step_rel_l2": rel_l2, "peak_device_mem_gib": peak,
    }))
    print("[ragged] decode profile: " + json.dumps(profile))
    checks = {
        f"launches == {cfg.n_layers} x {RAGGED_STEPS}":
            launches == cfg.n_layers * RAGGED_STEPS,
        "all logits finite": bool(finite),
        "First-Fit keeps the pool dense": watermark == used == need,
        f"first step within {FIRST_STEP_TOL} of max |logit|":
            delta <= FIRST_STEP_TOL * scale,
    }
    print(f"[ragged] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"ragged serving: {checks}")
    del params
    torch.cuda.empty_cache()
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

    # 2. the build: one nvcc per source, all started together
    from repro_torch.kernels.grouped_matmul import kernel as gmm_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel

    def timed_build(kernel):
        t0 = time.perf_counter()
        return kernel.build(), time.perf_counter() - t0

    with _phase("build"):
        with ThreadPoolExecutor(2) as pool:
            builds = list(pool.map(timed_build, (gmm_kernel, paged_kernel)))
        for lib, secs in builds:
            print(f"[build] {lib.relative_to(ROOT)} in {secs:.2f} s")

    # 3. the multiproc path, in a child process
    with _phase("multiproc"):
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), MP_FLAG],
            capture_output=True, text=True, timeout=600,
        )
        sys.stdout.write(child.stdout)
        sys.stderr.write(child.stderr[-4000:])
        if child.returncode != 0:
            raise RuntimeError(f"the child exited with {child.returncode}")
        mp_runs = [json.loads(line)["multiproc"]
                   for line in child.stdout.splitlines()
                   if line.startswith('{"multiproc"')]
        if [r["payload"] for r in mp_runs] != [size for size, _, _ in MP_RUNS]:
            raise RuntimeError(f"the child reported {mp_runs}")

    # 4. the grouped matmul against its plain version
    with _phase("kernel grouped_matmul"):
        gmm_record = kernel_phase(torch, np)

    # 5. the streaming slice at full size
    with _phase("full stream"):
        gmm_launches = full_phase(torch, np)

    # 6. the paged kernel against its plain version
    with _phase("kernel paged_attention"):
        paged_record, _ = paged_kernel_phase(torch, np)

    # 7. the serving entry point at full width
    with _phase("serve run_local"):
        serve_launches = serve_phase(torch)

    # 8. ragged prompts through prefill and paged decode
    with _phase("ragged serve"):
        ragged_launches = ragged_phase(torch, np)

    print(json.dumps({"kernels": [{
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/kernel.py:31",
        "launches": gmm_launches,
        "launches_by_path": {
            **{f"multiproc {r['payload']}": r["launches"] for r in mp_runs},
            "inproc full": gmm_launches,
        },
        **gmm_record,
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:39",
        "launches": serve_launches,
        "launches_by_path": {"serve run_local": serve_launches,
                             "ragged serve": ragged_launches},
        **paged_record,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
