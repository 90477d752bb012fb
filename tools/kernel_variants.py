#!/usr/bin/env python3
"""Where the grouped-matmul and paged-decode kernels spend their time, on
one card: variants of this checkout's sources, and the paged kernel's plan
and input lengths, each timed at ``chip_smoke.py``'s shapes.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/kernel_variants.py [gmm] [gmm-bf16] [paged-plan] [paged-lengths]
        [paged-parts]

With no argument it runs all five.  Each variant is the committed source
with a few text edits (each edit must apply, or the tool stops), built
with ``kernels/nvcc.py``'s flags under ``build/kernel_variants/`` and bound
with ``ctypes``:

- ``gmm``: the grouped matmul at the payload shape (f32, 128 x 128 x 2048
  x 2048), CUDA-event medians with the L2 flushed (``chip_smoke._time_ms``),
  each variant twice in turns, beside ``torch.bmm`` + row mask, with the SM
  clock and power ``nvidia-smi`` samples under the committed kernel.  A
  variant without loads computes garbage; its error is printed, not held.
- ``gmm-bf16``: the bf16 entry's tensor-core path at phase 4's three MoE
  bins (``chip_smoke.MOE_GMM``) under other tile widths, ring depths,
  blocks an SM and wgmma waits, and with parts taken out (the x or w
  copies, the wgmma, the stores), each twice in turns, with its relative
  l2 from the plain version, beside ``torch.bmm`` + row mask.
- ``paged-plan``: the paged kernel at phase 6's decode shape (bf16) under
  other split plans (``CHUNK_BYTES`` x ``SLOTS_PER_SM``), beside sdpa.
- ``paged-lengths``: the committed paged kernel's device time from
  ``torch.profiler`` at that shape with all lengths set alike (0, 16, 64,
  256, 1024) and with phase 6's own.
- ``paged-parts``: profiler device time of paged variants with the
  combine, the compute or the loads taken out, at phase 6's lengths.

Each measurement prints one JSON line, after a line with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_variants"

GMM_VARIANTS = {
    "committed": [],
    "no loads": [("            tiles.load_x(xe, d, row0, rows_live, (t + 1) * BK, tid);\n", ""),
                 ("            tiles.load_w(we, d, f, (t + 1) * BK, col0, tid, Bs[cur ^ 1]);\n", "")],
    "no x loads": [("            tiles.load_x(xe, d, row0, rows_live, (t + 1) * BK, tid);\n", "")],
    "8-deep k tiles": [("constexpr int BK = 16;", "constexpr int BK = 8;")],
    "128 x 128, 128 threads of 16 x 8": [
        ("constexpr int BN = 256;", "constexpr int BN = 128;"),
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;"),
        ("constexpr int WARPS_N = 4;", "constexpr int WARPS_N = 2;"),
        ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
    "128 x 128, 256 threads of 8 x 8": [
        ("constexpr int BN = 256;", "constexpr int BN = 128;"),
        ("constexpr int WARPS_N = 4;", "constexpr int WARPS_N = 2;"),
        ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
}
# the bf16 entry's tensor-core path (``gmm_tc_kernel``): tile width, ring
# depth, blocks an SM holds, and one more wgmma group kept in flight
_BF16_WAIT1 = [
    ("""        wg_commit();
        wg_wait<0>();
        keep(acc);
        if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
""", """        wg_commit();
        wg_wait<1>();  // the previous stage's products are done: release it
        if (t > 0 && (tid & 31) == 0) mbar_arrive(&empty[(stage + ST - 1) % ST]);
"""),
    ("    // The tile goes out through shared memory by TMA:",
     "    wg_wait<0>();\n    keep(acc);\n    // The tile goes out through shared memory by TMA:")]
GMM_BF16_VARIANTS = {
    "committed": [],
    # parts taken out (the result is then wrong; its error is printed, not held)
    "no x copies": [
        ("            for (int h = 0; h < halves; ++h)  // a half with no live row is not copied\n"
         "                tma_load(a + h * BOX_BYTES, tx, &full[stage], k0, row0 + h * HALF, e);\n",
         ""),
        ("(uint32_t)((halves + boxes) * BOX_BYTES)", "(uint32_t)(boxes * BOX_BYTES)")],
    "no w copies": [
        ("            for (int j = 0; j < boxes; ++j)\n"
         "                tma_load(b + j * BOX_BYTES, tw, &full[stage], col0 + 64 * j, k0, e);\n",
         ""),
        ("(uint32_t)((halves + boxes) * BOX_BYTES)", "(uint32_t)(halves * BOX_BYTES)")],
    "no wgmma": [("            wgmma_tn<BN>(acc, sw128_desc(a + kk * 32, 0),\n"
                  "                         sw128_desc(b + kk * 16 * 128, BOX_BYTES), 1);\n",
                  "            ;\n")],
    "no stores": [("            tma_store(sm + L::A + j * L::A_STAGE + c * BOX_BYTES, tout, "
                   "col0 + 64 * j, r0, e);", "            ;")],
    "256 wide, wait 1": _BF16_WAIT1,
    "128 wide, 6 stages": [("constexpr int TMA_BN = 256;", "constexpr int TMA_BN = 128;"),
                           ("constexpr int TMA_STAGES = 4;", "constexpr int TMA_STAGES = 6;")],
    "128 wide, 3 stages, 2 blocks an SM": [
        ("constexpr int TMA_BN = 256;", "constexpr int TMA_BN = 128;"),
        ("constexpr int TMA_STAGES = 4;", "constexpr int TMA_STAGES = 3;"),
        ("constexpr int TMA_MIN_BLOCKS = 1;", "constexpr int TMA_MIN_BLOCKS = 2;")],
    "128 wide, 3 stages, 2 blocks an SM, wait 1": [
        ("constexpr int TMA_BN = 256;", "constexpr int TMA_BN = 128;"),
        ("constexpr int TMA_STAGES = 4;", "constexpr int TMA_STAGES = 3;"),
        ("constexpr int TMA_MIN_BLOCKS = 1;", "constexpr int TMA_MIN_BLOCKS = 2;"),
        *_BF16_WAIT1],
}
PAGED_PARTS = {
    "committed": [],
    "no combine": [("if (!*last_s) return;", "return;")],
    "no compute": [("for (int e = tid; e < G * nt; e += THREADS) {",
                    "for (int e = tid; e < 0; e += THREADS) {"),
                   ("for (; t + 4 <= nt; t += 4) {", "for (; t + 4 <= 0; t += 4) {"),
                   ("for (; t < nt; ++t) {", "for (; t < 0; ++t) {")],
    "no loads": [("__pipeline_memcpy_async(ks + t * RS + col, k_pool + src, 16);", ""),
                 ("__pipeline_memcpy_async(vs + t * RS + col, v_pool + src, 16);", "")],
}
PAGED_PARTS["no loads, no compute"] = PAGED_PARTS["no loads"] + PAGED_PARTS["no compute"]


def build_variant(source: Path, name: str, edits) -> Path:
    """The source with ``edits`` applied, built into OUT; returns the library."""
    from repro_torch.kernels.nvcc import NVCC_FLAGS, _nvcc

    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source.name} variant {name!r}: {old!r} not found")
        text = text.replace(old, new)
    stem = f"{source.stem}_{name.replace(' ', '_').replace(',', '')}"
    cu, lib = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name!r}:\n{proc.stderr}")
    return lib


def build_all(source: Path, variants: dict) -> dict:
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = pool.map(lambda kv: build_variant(source, *kv), variants.items())
        return dict(zip(variants, libs))


def smi(query: str, seconds: float, work) -> list:
    """``nvidia-smi`` samples of ``query`` every 250 ms while ``work`` runs."""
    proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                             "-lms", "250"], stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        work()
    proc.terminate()
    lines = proc.communicate()[0].strip().splitlines()
    return lines[len(lines) // 3:]


def gmm(torch, cs) -> None:
    from repro_torch.kernels.grouped_matmul.kernel import SOURCE
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    libs = build_all(SOURCE, GMM_VARIANTS)
    x, w, gs = cs._payload_inputs(torch)
    E, C, d = x.shape
    f = w.shape[2]
    ref = grouped_matmul_ref(x, w, gs)
    out = torch.empty_like(ref)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def caller(path):
        lib = ctypes.CDLL(str(path))
        lib.gmm_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        return lambda: lib.gmm_f32(x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                   E, C, d, f, torch.cuda.current_stream().cuda_stream)

    calls = {name: caller(path) for name, path in libs.items()}
    order = list(calls) + list(calls)[::-1]
    for name in order:
        calls[name]()
        torch.cuda.synchronize()
        ms = cs._time_ms(torch, calls[name], 20, flush)
        print(json.dumps({"gmm": name, "ms": ms, "tflops": 2.0 * E * C * d * f / ms / 1e9,
                          "max_abs_err": (out - ref).abs().max().item()}), flush=True)
    bmm = cs._bmm_yardstick(torch, x, w, gs)
    print(json.dumps({"gmm": "torch.bmm + row mask",
                      "ms": cs._time_ms(torch, bmm, 20, flush)}), flush=True)

    def loop(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()

    for name, fn in (("committed", calls["committed"]), ("torch.bmm + row mask", bmm)):
        print(json.dumps({"gmm clocks": name, "samples": smi(
            "clocks.sm,power.draw", 3.0, lambda: loop(fn))}), flush=True)


def gmm_bf16(torch, cs) -> None:
    """The bf16 entry's tensor-core path under ``GMM_BF16_VARIANTS`` at the
    three MoE bins of phase 4, each variant twice in turns."""
    from repro_torch.kernels.grouped_matmul.kernel import SOURCE
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    libs = build_all(SOURCE, GMM_BF16_VARIANTS)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, E, C, d, f, tokens in cs.MOE_GMM:
        x, w, gs, _ = cs._moe_gmm_inputs(torch, E, C, d, f, tokens)
        ref = grouped_matmul_ref(x, w, gs).float()
        out = torch.empty((E, C, f), dtype=x.dtype, device="cuda")

        def caller(path):
            lib = ctypes.CDLL(str(path))
            lib.gmm_bf16_tma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.gmm_bf16_tma.restype = ctypes.c_int

            def call():
                code = lib.gmm_bf16_tma(x.data_ptr(), w.data_ptr(), gs.data_ptr(),
                                        out.data_ptr(), E, C, d, f,
                                        torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"launch failed: {code}")
            return call

        calls = {v: caller(path) for v, path in libs.items()}
        for v in list(calls) + list(calls)[::-1]:
            out.fill_(float("nan"))
            calls[v]()
            torch.cuda.synchronize()
            rel = ((out.float() - ref).norm() / ref.norm()).item()
            ms = cs._time_ms(torch, calls[v], 20, flush)
            print(json.dumps({"gmm bf16": name, "variant": v, "ms": ms, "rel_l2": rel}),
                  flush=True)
        print(json.dumps({"gmm bf16": name, "variant": "torch.bmm + row mask", "ms":
                          cs._time_ms(torch, cs._bmm_yardstick(torch, x, w, gs), 20, flush)}),
              flush=True)
        del x, w, gs, ref, out
        torch.cuda.empty_cache()


def _paged_inputs(torch, np, cs):
    args, lens = cs._decode_inputs(torch, np, torch.bfloat16)
    return args, lens, torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")


def _device_us(torch, fn, flush, n=20) -> float:
    """Mean device time of the paged kernel over ``n`` calls (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "paged_attn_kernel" in e.key:
            us = getattr(e, "self_device_time_total", None)
            return (us if us is not None else e.self_cuda_time_total) / e.count
    raise RuntimeError("the profiler saw no paged kernel")


def paged_plan(torch, np, cs) -> None:
    from repro_torch.kernels.paged_attention import kernel as pk

    args, lens, flush = _paged_inputs(torch, np, cs)
    bound = cs._paged_bound(args, lens)[0]
    planned = pk.CHUNK_BYTES, pk.SLOTS_PER_SM
    try:
        for chunk_kb in (18, 36, 54, 72):
            for per_sm in (2, 3, 4, 6, 8):
                pk.CHUNK_BYTES, pk.SLOTS_PER_SM = chunk_kb * 1024, per_sm
                ms = cs._time_ms(torch, lambda: pk.paged_decode_attention(*args), 50, flush)
                print(json.dumps({"paged plan": [chunk_kb, per_sm],
                                  "chunk_pages, slots, shared bytes":
                                      pk.launch_plan(*args[:2], args[3]),
                                  "ms": ms, "of_bound": bound / ms}), flush=True)
    finally:
        pk.CHUNK_BYTES, pk.SLOTS_PER_SM = planned
    print(json.dumps({"paged plan": "sdpa", "ms": cs._time_ms(
        torch, cs._sdpa_yardstick(torch, args, lens), 50, flush)}), flush=True)


def paged_lengths(torch, np, cs) -> None:
    from repro_torch.kernels.paged_attention import kernel as pk

    args, lens, flush = _paged_inputs(torch, np, cs)
    for name in ("phase 6", 0, 16, 64, 256, 1024):
        a = list(args)
        if name != "phase 6":
            a[4] = torch.full_like(args[4], name)
        print(json.dumps({"paged lengths": name, "device_us": _device_us(
            torch, lambda: pk.paged_decode_attention(*a), flush)}), flush=True)


def paged_parts(torch, np, cs) -> None:
    from repro_torch.kernels.paged_attention import kernel as pk

    libs = build_all(pk.SOURCE, PAGED_PARTS)
    args, lens, flush = _paged_inputs(torch, np, cs)
    built = pk._lib
    try:
        for name in list(libs) + list(libs)[::-1]:
            lib = ctypes.CDLL(str(libs[name]))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.paged_attn_bf16.argtypes = ([ptr] * 6 + [i32] * 7 + [ctypes.c_float]
                                            + [i32] * 3 + [ptr] * 3)
            lib.paged_attn_bf16.restype = i32
            lib.paged_attn_error_string.argtypes = [i32]
            lib.paged_attn_error_string.restype = ctypes.c_char_p
            pk._lib = lib
            print(json.dumps({"paged parts": name, "device_us": _device_us(
                torch, lambda: pk.paged_decode_attention(*args), flush)}), flush=True)
    finally:
        pk._lib = built


def main() -> None:
    parts = {"gmm": gmm, "gmm-bf16": gmm_bf16, "paged-plan": paged_plan,
             "paged-lengths": paged_lengths, "paged-parts": paged_parts}
    wanted = sys.argv[1:] or list(parts)
    if any(p not in parts for p in wanted):
        raise SystemExit(f"usage: kernel_variants.py [{' | '.join(parts)}] ...")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name in wanted:
        if name in ("gmm", "gmm-bf16"):
            parts[name](torch, cs)
        else:
            parts[name](torch, np, cs)


if __name__ == "__main__":
    main()
