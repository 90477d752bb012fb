"""The port's protocol checker (``repro_torch.analysis.protocol``) checks
itself, as ``tests/test_protocol.py`` checks the JAX package's, and is held
to the JAX package's checker.

1. **Extraction (R7)** — synthetic ``src/repro_torch/runtime/...`` trees
   prove each extraction obligation fires (uncovered emit, stale
   declaration, unknown event or entity, mirror assignment without a
   declaration, a data-channel read outside ``@loop_only``, manifest drift)
   and that a fully annotated tree extracts clean; the real tree extracts
   clean against the port's committed manifest.
2. **Model check** — the committed manifest explores clean over every
   interleaving of the bounded configuration (2153 states, 7885
   transitions), and the seeded mutations (dropping the requeue edge;
   harvesting before the drain) produce counterexample traces.
3. **Conformance (R8)** — replays of hand-written event sequences (legal,
   out of order, duplicate completion, activity after a kill, in flight at
   the end of the log), rule R8 over log directories, and both CLIs
   (``python -m repro_torch.analysis.protocol``, ``python -m
   repro_torch.obs conformance``).
4. **Robustness** — ``match`` and walrus syntax in a protocol module is
   analysed, not skipped; a protocol module that does not parse surfaces
   as a ``parse`` finding under R7 and R8.
5. **Against the JAX package** — the port's extractor over the JAX
   runtime gives the JAX manifest; the port's manifest is the JAX one with
   its paths renamed plus the ``_EV_PAYLOAD`` frame; both explorers agree
   on counts, verdicts and counterexample lengths; both replays agree,
   violation for violation, on the hand-written logs and on the event logs
   of the port's live runtime on the CPU (microscopy smoke, in-process and
   multiproc, and multiproc with worker 0 killed while it is busiest).
   The manifests' ``_comment`` names each package's CLI and is left out of
   the comparisons.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.model import RepoIndex
from repro_torch.analysis.protocol import (
    PROTOCOL_MANIFEST_PATH,
    PROTOCOL_MODULES,
    SIM_PATH,
    BoundedConfig,
    check_protocol_model,
    check_trace_conformance,
    drop_transition,
    explore,
    extract_findings,
    extract_protocol,
    render_trace,
    replay_events,
)
from repro_torch.analysis.protocol.__main__ import main as protocol_main
from repro_torch.obs.__main__ import main as obs_main

REPO_ROOT = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO_ROOT / PROTOCOL_MANIFEST_PATH).read_text(encoding="utf-8"))
JAX_MANIFEST_PATH = "src/repro/analysis/protocol/protocol_manifest.json"
JAX_MODULES = tuple(p.replace("src/repro_torch/", "src/repro/") for p in PROTOCOL_MODULES)
EVENTS = "src/repro_torch/obs/event_manifest.json"
MASTER = "src/repro_torch/runtime/master.py"


def _write_tree(root: Path, files: dict) -> Path:
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content, encoding="utf-8")
    return root


def _messages(findings, rule="R7"):
    return [f.message for f in findings if f.rule == rule]


def _without_comment(manifest: dict) -> dict:
    return {k: v for k, v in manifest.items() if k != "_comment"}


# ---------------------------------------------------------------------------
# Extraction (R7)
# ---------------------------------------------------------------------------

_FX_EVENTS = json.dumps({
    "version": 1,
    "events": {
        "msg.enqueued": {"fields": ["msg_id"]},
        "msg.requeued": {"fields": ["msg_id"]},
    },
})

_FX_MASTER_CLEAN = (
    "from .annotations import transition\n"
    "\n"
    '@transition("msg", "msg.enqueued", src="created", dst="enqueued")\n'
    "def push_back(bus, m):\n"
    '    bus.emit("msg.enqueued", msg_id=m.msg_id)\n'
    "\n"
    '@transition("msg", "msg.requeued", src="pulled", dst="requeued")\n'
    "def requeue(bus, m):\n"
    '    bus.emit("msg.requeued", msg_id=m.msg_id)\n'
)


def _extract(tmp_path):
    return extract_protocol(RepoIndex(tmp_path), tmp_path)


@pytest.mark.timeout(30)
def test_annotated_fixture_extracts_clean(tmp_path):
    _write_tree(tmp_path, {EVENTS: _FX_EVENTS, MASTER: _FX_MASTER_CLEAN})
    manifest, findings = _extract(tmp_path)
    assert _messages(findings) == []
    msg = manifest["entities"]["msg"]
    assert {t["event"] for t in msg["transitions"]} == {"msg.enqueued", "msg.requeued"}
    assert msg["initial"] == "created" and msg["terminal"] == ["completed"]


_FINDING_CASES = {
    "uncovered emit": (
        {MASTER: ("def push_back(bus, m):\n"
                  '    bus.emit("msg.enqueued", msg_id=m.msg_id)\n')},
        ["not covered by a @transition"]),
    "stale declaration": (
        {MASTER: ("from .annotations import transition\n"
                  '@transition("msg", "msg.requeued", src="pulled", dst="requeued")\n'
                  "def requeue(bus, m):\n"
                  "    pass\n")},
        ["stale @transition"]),
    "unknown event and entity": (
        {MASTER: ("from .annotations import transition\n"
                  '@transition("msg", "msg.vanished", src="a", dst="b")\n'
                  "def a(bus, m):\n"
                  '    bus.emit("msg.vanished", msg_id=1)\n'
                  '@transition("ghost", "msg.enqueued", src="a", dst="b")\n'
                  "def b(bus, m):\n"
                  '    bus.emit("msg.enqueued", msg_id=1)\n')},
        # the ghost's emit is then a transition nothing declares
        ["is not registered", "entity 'ghost' is unknown", "not covered by a @transition"]),
    "uncovered mirror assignment": (
        {"src/repro_torch/runtime/worker.py": ("def harvest(slot):\n"
                                               "    slot.state = WorkerState.OFF\n")},
        ["mirror assignment .state = WorkerState.OFF"]),
    "data-channel read outside loop_only": (
        {"src/repro_torch/runtime/transport.py": ("def steal(self):\n"
                                                  "    return self.data_q.get()\n")},
        ["single-consumer"]),
}


@pytest.mark.timeout(30)
@pytest.mark.parametrize("case", sorted(_FINDING_CASES))
def test_extraction_obligation_is_a_finding(tmp_path, case):
    files, wanted = _FINDING_CASES[case]
    _write_tree(tmp_path, {EVENTS: _FX_EVENTS, **files})
    msgs = _messages(_extract(tmp_path)[1])
    assert len(msgs) == len(wanted), msgs
    for want in wanted:
        assert any(want in m for m in msgs), (want, msgs)


@pytest.mark.timeout(30)
def test_drift_against_committed_manifest_is_a_finding(tmp_path):
    _write_tree(tmp_path, {EVENTS: _FX_EVENTS, MASTER: _FX_MASTER_CLEAN})
    index = RepoIndex(tmp_path)
    manifest, _ = extract_protocol(index, tmp_path)
    assert any("manifest is missing" in m for m in _messages(extract_findings(index, tmp_path)))

    committed_file = tmp_path / PROTOCOL_MANIFEST_PATH
    committed_file.parent.mkdir(parents=True, exist_ok=True)
    committed_file.write_text(json.dumps(manifest), encoding="utf-8")
    assert _messages(extract_findings(index, tmp_path)) == []

    tampered = json.loads(json.dumps(manifest))
    tampered["entities"]["msg"]["transitions"][0]["src"] = ["started"]
    committed_file.write_text(json.dumps(tampered), encoding="utf-8")
    msgs = _messages(extract_findings(index, tmp_path))
    assert len(msgs) == 1 and "protocol drift" in msgs[0]


@pytest.mark.timeout(120)
def test_r7_real_tree_extracts_clean_and_matches_manifest():
    findings = check_protocol_model(RepoIndex(REPO_ROOT), REPO_ROOT)
    assert findings == [], "\n".join(f"{f.path}:{f.line}: {f.message}" for f in findings)


# ---------------------------------------------------------------------------
# The bounded model check
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_bounded_model_check_is_exhaustive_and_clean():
    result = explore(COMMITTED, BoundedConfig())
    assert result.ok, [v.message for v in result.violations]
    assert (result.states, result.transitions) == (2153, 7885)


@pytest.mark.timeout(120)
def test_dropping_the_requeue_edge_produces_a_counterexample():
    result = explore(drop_transition(COMMITTED, "msg.requeued"), BoundedConfig())
    assert not result.ok
    v = result.violations[0]
    assert v.invariant == "I1" and "requeue" in v.message and len(v.trace) >= 2
    rendered = render_trace(v)
    assert "kill" in rendered and "I1" in rendered


@pytest.mark.timeout(120)
def test_unsafe_harvest_order_produces_a_race_counterexample():
    result = explore(COMMITTED, BoundedConfig(), unsafe_harvest=True)
    assert not result.ok
    assert any(v.invariant == "I4" for v in result.violations)


@pytest.mark.timeout(120)
def test_mutated_manifest_fails_r7(tmp_path):
    """A committed manifest whose requeue edge is gone is caught by R7 as a
    model-check finding with a trace, and as drift from the code."""
    for rel in (*PROTOCOL_MODULES, "src/repro_torch/runtime/annotations.py", SIM_PATH, EVENTS):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO_ROOT / rel, dst)
    committed_file = tmp_path / PROTOCOL_MANIFEST_PATH
    committed_file.parent.mkdir(parents=True, exist_ok=True)
    committed_file.write_text(json.dumps(drop_transition(COMMITTED, "msg.requeued")),
                              encoding="utf-8")
    msgs = _messages(check_protocol_model(RepoIndex(tmp_path), tmp_path))
    assert any("model-check violation [I1]" in m for m in msgs)
    assert any("protocol drift" in m for m in msgs)


# ---------------------------------------------------------------------------
# Trace conformance (R8)
# ---------------------------------------------------------------------------


def _ev(ev, seq, **fields):
    return {"ev": ev, "seq": seq, "t": float(seq), **fields}


def _legal_sequence():
    return [
        _ev("worker.boot", 0, worker=0),
        _ev("worker.active", 1, worker=0),
        _ev("pe.spawn", 2, worker=0, pe=0),
        _ev("msg.enqueued", 3, msg_id=0),
        # no explicit PE-ready event: the replay must promote the PE
        # starting->idle over the internal epsilon edge before idle->busy
        _ev("msg.pulled", 4, msg_id=0, worker=0, pe=0),
        _ev("msg.started", 5, msg_id=0, worker=0, pe=0),
        _ev("msg.completed", 6, msg_id=0, worker=0, pe=0),
        _ev("pe.exit", 7, worker=0, pe=0),
        _ev("worker.deactivate", 8, worker=0),
    ]


def _pulled_prefix(msg_event="msg.enqueued"):
    out = [_ev("worker.boot", 0, worker=0), _ev("worker.active", 1, worker=0),
           _ev("pe.spawn", 2, worker=0, pe=0)]
    if msg_event:
        out.append(_ev(msg_event, 3, msg_id=0))
    return out + [_ev("msg.pulled", 4, msg_id=0, worker=0, pe=0)]


def _duplicate_completion():
    events = _legal_sequence()
    events.insert(7, _ev("msg.completed", 99, msg_id=0, worker=0, pe=0))
    return events


def _killed():
    return _pulled_prefix() + [_ev("worker.kill", 5, worker=0),
                               _ev("msg.requeued", 6, msg_id=0)]


def _active_after_kill():
    # a SIGKILLed slot must never produce further events
    return _killed() + [_ev("worker.active", 7, worker=0)]


# name -> (events, strict_end, (entity, text) of a violation, or None if clean)
_LOGS = {
    "legal": (_legal_sequence, True, None),
    "pull without enqueue": (lambda: _pulled_prefix(None), False,
                             ("msg", "illegal from state 'created'")),
    "duplicate completion": (_duplicate_completion, False, ("msg", "duplicate completion")),
    "activity after a kill": (_active_after_kill, False,
                              ("worker", "failed worker instance")),
    "requeued at the end": (_killed, True, None),
    "in flight at the end": (_pulled_prefix, True, ("msg", "delivery lost")),
    "in flight at the end, lenient": (_pulled_prefix, False, None),
}


@pytest.mark.timeout(30)
@pytest.mark.parametrize("name", sorted(_LOGS))
def test_replay_of_a_hand_written_log(name):
    make, strict, flagged = _LOGS[name]
    summary = replay_events(make(), COMMITTED, strict_end=strict)
    if flagged is None:
        assert summary.ok, [str(v) for v in summary.violations]
    else:
        entity, text = flagged
        assert any(v.entity == entity and text in v.message for v in summary.violations), \
            [str(v) for v in summary.violations]
    if name == "legal":
        assert summary.completed == 1 and summary.backlog == 0
    if name == "requeued at the end":  # backlog, not a violation
        assert summary.backlog == 1 and summary.requeued == 1


def _log_file(path: Path, events, prefix: str = "") -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prefix + "\n".join(json.dumps(e) for e in events) + "\n",
                    encoding="utf-8")
    return path


@pytest.mark.timeout(30)
def test_r8_over_log_directories(tmp_path):
    good = _log_file(tmp_path / "good" / "events.jsonl", _legal_sequence())
    _log_file(tmp_path / "bad" / "events.jsonl", _duplicate_completion(),
              prefix="not json at all\n")
    index = RepoIndex(REPO_ROOT)
    assert check_trace_conformance(index, REPO_ROOT) == []  # no logs: a no-op
    assert check_trace_conformance(index, REPO_ROOT, events=[good.parent]) == []
    msgs = _messages(check_trace_conformance(index, REPO_ROOT, events=[tmp_path]), "R8")
    assert any("duplicate completion" in m for m in msgs)
    assert any("not valid JSON" in m for m in msgs)


# ---------------------------------------------------------------------------
# CLI surfaces
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_protocol_cli_extract_and_check(capsys):
    assert protocol_main(["--root", str(REPO_ROOT), "extract", "--diff"]) == 0
    assert protocol_main(["--root", str(REPO_ROOT), "check"]) == 0
    out = capsys.readouterr().out
    assert "explored 2153 states / 7885 transitions" in out
    assert "all delivery invariants hold" in out

    rc = protocol_main(["--root", str(REPO_ROOT), "check", "--mutate", "msg.requeued"])
    out = capsys.readouterr().out
    assert rc == 1 and "[I1]" in out and "counterexample" in out


@pytest.mark.timeout(30)
def test_protocol_and_obs_conformance_clis(tmp_path, capsys):
    log = _log_file(tmp_path / "events.jsonl", _legal_sequence())
    assert protocol_main(["--root", str(REPO_ROOT), "conformance", str(tmp_path)]) == 0
    capsys.readouterr()
    assert obs_main(["conformance", str(log)]) == 0
    assert "0 violation(s)" in capsys.readouterr().out

    _log_file(log, _legal_sequence()[:-4])  # ends with the message started
    assert obs_main(["conformance", str(log)]) == 1
    capsys.readouterr()
    assert obs_main(["conformance", "--lenient-end", str(log)]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Robustness: modern syntax and unparsable files
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_match_and_walrus_syntax_are_analyzed_not_skipped(tmp_path):
    _write_tree(tmp_path, {EVENTS: _FX_EVENTS, MASTER: (
        "def f(bus, m, x):\n"
        "    match x:\n"
        "        case 1:\n"
        "            if (y := m.msg_id):\n"
        '                bus.emit("msg.enqueued", msg_id=y)\n'
        "        case _:\n"
        "            return 0\n")})
    msgs = _messages(_extract(tmp_path)[1])
    assert len(msgs) == 1 and "not covered by a @transition" in msgs[0]


@pytest.mark.timeout(30)
def test_unparsable_protocol_module_surfaces_for_r7_and_r8(tmp_path):
    _write_tree(tmp_path, {EVENTS: _FX_EVENTS, MASTER: "def oops(:\n"})
    committed_file = tmp_path / PROTOCOL_MANIFEST_PATH
    committed_file.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO_ROOT / PROTOCOL_MANIFEST_PATH, committed_file)
    log = _log_file(tmp_path / "events.jsonl", _legal_sequence())
    for rule, found in (
            ("R7", check_protocol_model(RepoIndex(tmp_path), tmp_path)),
            ("R8", check_trace_conformance(RepoIndex(tmp_path), tmp_path, events=[log]))):
        assert any(f.rule == "parse" and f.path == MASTER for f in found), \
            f"parse failure invisible under {rule}"


# ---------------------------------------------------------------------------
# Against the JAX package's checker
# ---------------------------------------------------------------------------


@pytest.mark.timeout(60)
def test_port_extractor_over_the_jax_runtime_gives_the_jax_manifest():
    manifest, findings = extract_protocol(
        RepoIndex(REPO_ROOT), REPO_ROOT, modules=JAX_MODULES,
        sim_path="src/repro/core/sim.py", event_manifest="src/repro/obs/event_manifest.json")
    assert findings == []
    jax = json.loads((REPO_ROOT / JAX_MANIFEST_PATH).read_text(encoding="utf-8"))
    assert _without_comment(manifest) == _without_comment(jax)


@pytest.mark.timeout(30)
def test_port_manifest_is_the_jax_manifest_renamed_plus_the_payload_frame():
    jax = json.loads((REPO_ROOT / JAX_MANIFEST_PATH).read_text(encoding="utf-8")
                     .replace("src/repro/", "src/repro_torch/"))
    port = json.loads(json.dumps(COMMITTED))
    frame = port["wire"]["frames"].pop("_EV_PAYLOAD")
    transport = "src/repro_torch/runtime/transport.py"
    assert frame == {
        "channel": "data",
        "producers": [f"{transport}:_mp_worker_main"],
        "consumers": [f"{transport}:MultiprocTransport._handle_event",
                      f"{transport}:MultiprocTransport.kill_worker"]}
    assert _without_comment(port) == _without_comment(jax)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mutation", ["none", "msg.requeued", "unsafe harvest"])
def test_both_explorers_agree(mutation):
    from repro.analysis.protocol import drop_transition as jax_drop
    from repro.analysis.protocol import explore as jax_explore

    jax = json.loads((REPO_ROOT / JAX_MANIFEST_PATH).read_text(encoding="utf-8"))
    unsafe = mutation == "unsafe harvest"
    results = []
    for manifest in (COMMITTED, jax):
        if mutation == "msg.requeued":
            manifest = drop_transition(manifest, mutation)
            assert jax_drop(manifest, mutation) == manifest
        results.append((explore(manifest, BoundedConfig(), unsafe_harvest=unsafe),
                        jax_explore(manifest, unsafe_harvest=unsafe)))
    for port, ref in results:
        assert (port.states, port.transitions, port.ok) == (ref.states, ref.transitions, ref.ok)
        assert [(v.invariant, v.message, v.trace) for v in port.violations] == \
            [(v.invariant, v.message, v.trace) for v in ref.violations]
    port = results[0][0]
    if mutation == "none":
        assert port.ok and (port.states, port.transitions) == (2153, 7885)
    elif mutation == "msg.requeued":
        assert [v.invariant for v in port.violations] == ["I1"]
    else:
        assert any(v.invariant == "I4" for v in port.violations)


def _replays_agree(events, strict_end=True):
    from repro.analysis.protocol import replay_events as jax_replay

    jax = json.loads((REPO_ROOT / JAX_MANIFEST_PATH).read_text(encoding="utf-8"))
    port = replay_events(events, COMMITTED, strict_end=strict_end)
    ref = jax_replay(events, jax, strict_end=strict_end)
    assert [str(v) for v in port.violations] == [str(v) for v in ref.violations]
    assert (port.events, port.completed, port.requeued, port.backlog) == \
        (ref.events, ref.completed, ref.requeued, ref.backlog)
    return port


@pytest.mark.timeout(30)
@pytest.mark.parametrize("name", sorted(_LOGS))
def test_both_replays_agree_on_a_hand_written_log(name):
    make, strict, flagged = _LOGS[name]
    assert _replays_agree(make(), strict).ok == (flagged is None)


# one live run of the port on the CPU in a fresh interpreter (the multiproc
# transport forks its workers, and a process that ran torch ops before the
# fork can hang them): microscopy smoke, first-fit, the torch payload's
# plain version, an EventBus written to argv[4]
LIVE_RUN = r"""
import json, sys
from repro_torch.core.irm import IRM
from repro_torch.obs.bus import EventBus
from repro_torch.obs.exporters import write_jsonl
from repro_torch.runtime import RuntimeConfig, run_live
from repro_torch.scenarios.registry import get_scenario

transport, scale, kill, out = sys.argv[1], float(sys.argv[2]), sys.argv[3], sys.argv[4]
scn = get_scenario("microscopy")
cfg = scn.sim_config()
cfg.t_max = scn.smoke_t_max
if kill:
    worker, t = kill.split(":")
    cfg.fail_worker_at = (int(worker), float(t))
ic = scn.irm_config()
ic.allocator.algorithm = "first-fit"
bus = EventBus()
res = run_live(scn.make_stream(0, **scn.smoke_overrides), cfg, irm=IRM(ic),
               runtime=RuntimeConfig(time_scale=scale, payload="torch",
                                     payload_kwargs={"device": "cpu"}, transport=transport),
               bus=bus)
write_jsonl(out, bus.events)
print(json.dumps({"completed": res.completed, "total": res.total}))
"""

# (transport, time scale, kill): worker 0 is killed at 36 s, inside the
# 34-44 s window where the simulator shows it running 8 messages at once
_RUNS = {"inproc": ("inproc", "0.02", ""), "multiproc": ("multiproc", "0.02", ""),
         "multiproc, worker 0 killed": ("multiproc", "0.05", "0:36")}


@pytest.mark.timeout(200)
@pytest.mark.parametrize("run", sorted(_RUNS))
def test_both_replays_agree_on_a_live_run_of_the_port(tmp_path, run):
    from repro_torch.analysis.protocol import load_events_file

    log = tmp_path / "events.jsonl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO_ROOT / "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", LIVE_RUN, *_RUNS[run], str(log)],
                          cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["completed"] == res["total"] == 40
    events, errors = load_events_file(log)
    assert errors == [] and events
    summary = _replays_agree(events)
    assert summary.ok and summary.completed == 40
    kinds = {e["ev"] for e in events}
    if "killed" in run:
        assert summary.requeued >= 1 and "worker.kill" in kinds
    else:
        assert summary.requeued == 0 and "worker.kill" not in kinds

