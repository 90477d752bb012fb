"""The readers of the program's own spans and counters
(``program_trace`` and the four metrics that read it), on synthetic traces
with known answers, and without records, as on a port that has no
recorder: each gives None there."""

import json
import sys
import types

import pytest

from portbench import harness, program_trace
from portbench.conftest import write_root
from repro_torch.obs.spans import Count, Span

READERS = ["ce_share.train", "adamw_share.train", "pad_share.prefill",
           "launch_idle_share.tail"]


def span(name, start, end, id_=0, parent=None, step=1, marks=None):
    return Span(name, start, end, id_, parent, 1, step, marks)


MARKER_OP = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def record(window, device=(), counters=None, markers=(), spans=()):
    ops = [("op", s, e) for s, e in device] + [(MARKER_OP, s, e) for s, e in markers]
    trace = harness.Trace(window, list(spans), ops, {})
    return harness.Record({}, counters or {}, trace)


@pytest.fixture
def program(monkeypatch):
    """Stands in for what the port recorded in the segment."""
    seen = []
    monkeypatch.setattr(program_trace, "_seen", seen)
    return seen


def read(name, rec):
    return harness._reader(name).read(rec)


# two steps; the cross-entropy forward and backward and AdamW inside each
TRAIN = [span("train.step", 0, 400), span("train.cross_entropy", 50, 100),
         span("train.cross_entropy.bwd", 200, 260), span("train.adamw", 350, 400),
         span("train.step", 500, 900, step=2), span("train.cross_entropy", 600, 650, step=2),
         span("train.adamw", 860, 900, step=2)]
TRAIN_DEVICE = [(10, 390), (510, 700), (700, 890), (950, 990)]  # the last after the steps


def test_ce_share_reads_the_cross_entropys_busy_time_over_the_steps(program):
    program += TRAIN
    # busy in the steps: 380 + 380; in the cross-entropy: 50 + 60 + 50
    assert read("ce_share.train", record((0, 1000), TRAIN_DEVICE)) == pytest.approx(
        100 * 160 / 760)


def test_adamw_share_reads_adamws_busy_time_over_the_steps(program):
    program += TRAIN
    # adamw: 350-390 busy in the first step, 860-890 in the second
    assert read("adamw_share.train", record((0, 1000), TRAIN_DEVICE)) == pytest.approx(
        100 * 70 / 760)


def test_train_shares_take_only_the_windows_spans(program):
    program += TRAIN + [span("train.step", -500, -100), span("train.adamw", -300, -100)]
    device = TRAIN_DEVICE + [(-450, -150)]
    assert read("adamw_share.train", record((0, 1000), device)) == pytest.approx(100 * 70 / 760)


# one step marked on the card: its host stamps lie elsewhere, and only the
# markers on the device's timeline place its spans
MARKED = [span("train.step", 500, 600, marks=(0, 7)),
          span("train.cross_entropy", 510, 520, marks=(1, 2)),
          span("train.cross_entropy.bwd", 530, 540, marks=(3, 4)),
          span("train.adamw", 550, 560, marks=(5, 6))]
MARKERS = [(0, 1), (100, 101), (150, 151), (200, 201), (260, 261), (350, 351), (390, 391),
           (399, 400)]
MARKED_DEVICE = [(10, 100), (105, 150), (160, 200), (201, 260), (270, 350), (351, 390)]
# busy inside the step (1, 399): the work, 359, and markers 1 to 6
MARKED_BUSY = 90 + 45 + 40 + 59 + 80 + 39 + 6


def test_marked_spans_are_taken_between_their_markers_on_the_device(program):
    program += MARKED
    rec = record((0, 1000), MARKED_DEVICE, markers=MARKERS)
    assert program_trace.spans_named(rec.trace, "train.cross_entropy") == [(101, 150)]
    assert read("ce_share.train", rec) == pytest.approx(100 * (45 + 59) / MARKED_BUSY)
    assert read("adamw_share.train", rec) == pytest.approx(100 * 39 / MARKED_BUSY)


def test_marked_spans_give_nothing_when_a_marker_is_missing(program):
    program += MARKED
    rec = record((0, 1000), MARKED_DEVICE, markers=MARKERS[:-1])
    assert program_trace.spans_named(rec.trace, "train.step") == []
    assert read("ce_share.train", rec) is None and read("adamw_share.train", rec) is None


def test_idle_is_split_by_the_innermost_span(program):
    """The program's spans first (a marked one on the device's timeline),
    then the benchmark's, then "other"."""
    program += MARKED
    rec = record((0, 1000), MARKED_DEVICE, markers=MARKERS, spans=[("train_step", 395, 450)])
    got = program_trace.idle_by_span(rec.trace)
    want = {"train.step": 9 + 9 + 9 + 8, "train.cross_entropy": 4,
            "harness:train_step": 50, "other": 550}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})


def test_pad_share_reads_the_counters_inside_the_window(program):
    program += [Count("prefill.positions", 10, 100), Count("prefill.tokens", 10, 50),
                Count("prefill.positions", 20, 60), Count("prefill.tokens", 20, 30),
                Count("prefill.positions", 2000, 999), Count("prefill.tokens", 2000, 1)]
    assert read("pad_share.prefill", record((0, 1000))) == pytest.approx(50.0)


def test_launch_idle_share_counts_no_idle_after_an_unfenced_span_ends(program):
    """The first span's last operation runs on past its end, and the device
    then idles before an operation outside every span: neither is idle
    time of a span; inside the spans 10 + 40 of 200 ns are idle."""
    program += [span("prefill", 0, 120), span("prefill.layers", 0, 100),
                span("prefill.layers", 300, 400, step=2)]
    device = [(10, 40), (80, 130), (150, 200), (300, 350), (350, 400)]
    assert read("launch_idle_share.tail", record((0, 1000), device)) == pytest.approx(25.0)


def test_busy_inside_clips_each_operation_to_the_spans():
    rec = record((0, 100), [(0, 10), (5, 30), (40, 60), (90, 100)])
    assert program_trace.busy_inside(rec.trace, [(20, 50), (45, 95)]) == 10 + 20 + 5
    assert program_trace.union([(5, 9), (0, 3), (2, 4)]) == [(0, 4), (5, 9)]
    assert program_trace.length([(0, 4), (2, 6), (10, 11)]) == 7


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_its_records(program, name):
    assert read(name, harness.Record({}, {}, None)) is None
    assert read(name, record((0, 1000), TRAIN_DEVICE)) is None
    if name != "pad_share.prefill":  # a device metric reads nothing off the device
        program += TRAIN + [span("prefill.layers", 0, 100)]
        assert read(name, record((0, 1000))) is None
        program.clear()
    program += [span("unrelated", 0, 10), Count("other", 5, 1)]
    assert read(name, record((0, 1000), TRAIN_DEVICE)) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_on_a_port_without_the_recorder(program, monkeypatch, name):
    """The parent of the recorder's change: ``repro_torch.obs`` has no
    ``spans``, so the readers find nothing and raise nothing."""
    obs = types.ModuleType("repro_torch.obs")
    obs.__path__ = []  # a package in which no submodule is found
    monkeypatch.setitem(sys.modules, "repro_torch.obs", obs)
    monkeypatch.delitem(sys.modules, "repro_torch.obs.spans")
    with pytest.raises(ImportError):
        from repro_torch.obs import spans  # noqa: F401
    rec = record((0, 1000), TRAIN_DEVICE)
    assert read(name, rec) is None


@pytest.mark.parametrize("cell, present, absent", [
    ("qwen3-8b.prefill-short", ["pad_share.prefill"], []),
    ("qwen3-8b.prefill-short-tail", [], ["launch_idle_share.tail"]),
    ("olmo-1b.train-4k", [], ["ce_share.train", "adamw_share.train"]),
])
def test_a_traced_smoke_run_reports_the_programs_counters(tmp_path, capsys, cell, present,
                                                          absent):
    """A whole traced run on the CPU: the prefill counters reach the result
    line; the device readers, with no device operation, give nothing."""
    root, _ = write_root(tmp_path)
    rc = harness.main(["--workload", cell, "--seed", "2876543210", "--seconds", "0.3",
                       "--trace", "1"], root=root, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"]
    for name in present:
        assert 0 < out["metrics"][name]["value"] < 100 and out["metrics"][name]["unit"] == "%"
    for name in absent:
        assert name not in out["metrics"]


def test_the_idle_split_runs_a_cell_traced(tmp_path, capsys):
    """``python3 portbench/program_trace.py``: the result line, then the
    traced segment's idle time by span, which adds up to its idle time."""
    root, _ = write_root(tmp_path)
    rc = program_trace.main(["--workload", "qwen3-8b.prefill-short-tail", "--seed",
                             "2876543210", "--seconds", "0.3"], root=root, device="cpu")
    result, split = (json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[-2:])
    assert rc == 0 and result["correct"]
    assert {"prefill.layers", "prefill.plan"} <= set(split["idle_by_span_s"])
    assert sum(split["idle_by_span_s"].values()) == pytest.approx(
        split["window_s"] - split["busy_s"])
