"""The check that decides ``correct``, driven through whole runs at smoke
size on the CPU (the look for a card skipped): a sound run comes out
correct; the control (the reference in fp8 in the program's place) and
each fault planted under the timed path come out not correct."""

import json

import pytest
import torch

from portbench import control, faults, harness
from portbench.conftest import write_root

CELLS = {"olmo-1b.train-4k": "packed_train", "qwen3-8b.prefill-short": "batched_prefill",
         "qwen3-8b.prefill-short-tail": "batched_prefill"}


def run(root, cell, capsys, seed=2 ** 31 + 17):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3"],
                      root=root, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(smoke_root, cell, capsys):
    out = run(smoke_root, cell, capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(
        harness.load_cell(smoke_root, cell).limits)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_caught(smoke_root, cell, fault, capsys):
    with faults.planted(CELLS[cell], fault):
        out = run(smoke_root, cell, capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_apart_from_the_program(smoke_root, cell):
    """The separation the limits rest on, kept at a size a test holds: the
    control reads three times what the program reads or more on one number
    at least (on the card, at the cell's size, it fails the limits)."""
    c = harness.load_cell(smoke_root, cell)
    sound = control.program(c, 5, 0.3, torch.device("cpu"))
    low = control.control(c, 5, 0.3, torch.device("cpu"))
    assert any(low[k] >= 3 * sound[k] > 0 for k in low), (low, sound)


def test_the_control_script_judges_each_reading(tmp_path):
    """Each reading goes through the harness's comparison with the cell's
    limits; the script fails if a sound run is judged wrong or a fault
    right (here: limits loosened past every reading)."""
    root, _ = write_root(tmp_path / "root")
    out = tmp_path / "readings.jsonl"
    args = ["--workload", "qwen3-8b.prefill-short-tail", "--seeds", "1", "--fault-seeds", "1",
            "--seconds", "0.3", "--out", str(out)]
    assert control.main(args, root=root, device="cpu") == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(x["reading"], x["fault"], x["correct"]) for x in lines] == [
        ("program", None, True), ("fault", "state_unchanged", False),
        ("fault", "half_batch", False), ("fault", "token_altered", False)]
    limits = root / "portbench" / "limits" / "qwen3-8b.batched_prefill.json"
    loose = json.loads(limits.read_text())
    loose["limits"] = {k: 1e9 for k in loose["limits"]}
    limits.write_text(json.dumps(loose))
    assert control.main(args[:4] + ["--fault-seeds", "1", "--seconds", "0.3"],
                        root=root, device="cpu") == 1


def test_the_sweep_reads_a_queue(smoke_root):
    """``sweep.py``'s reading of one rate, on the program at smoke size."""
    import time

    from portbench import sweep
    from portbench.drivers import batched_prefill

    c = harness.load_cell(smoke_root, "qwen3-8b.prefill-short-tail")
    ctx = harness.Context(c, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
    prog = batched_prefill.Program(ctx)
    out = sweep.point(prog, c.config, dict(c.traffic, arrival_rate=200.0), 3, 0.2)
    assert out["requests"] > 1 and out["mean_batch"] >= 1
    assert out["ttft_p95_ms"] >= out["ttft_p50_ms"] > 0 and out["tokens_per_s"] > 0


def test_a_timed_window_ends_on_a_whole_cycle(smoke_root):
    """Above the knee the window holds whole passes of the lengths, so that
    every run times the same mix."""
    import time

    from portbench.drivers import batched_prefill

    c = harness.load_cell(smoke_root, "qwen3-8b.prefill-short")
    ctx = harness.Context(c, 4, 0.3, False, torch.device("cpu"), time.perf_counter())
    out = batched_prefill.run(ctx)
    cycle = c.traffic["cycle_batches"]
    assert cycle > 1 and out["counters"]["batches"] % cycle == 0
    assert out["counters"]["requests"] == out["counters"]["batches"] * c.traffic["batch"]
