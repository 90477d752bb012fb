"""The port's invariant checker checks itself: fixtures, JAX, the real tree.

``python -m repro_torch.analysis`` runs rules R1-R6 of the JAX package's
checker over the port's trees, beside the protocol rules R7 and R8
(``tests/test_torch_protocol.py``).  Four parts:

1. **Fixtures** — each case of ``tests/test_analysis.py`` (R1-R6, a
   parse failure, the baseline), as a minimal tree in the
   ``src/repro_torch/...`` layout holding exactly one violation, proving
   the rule *fires*; and the cases only the port has: the torch idiom's
   host syncs (R1), torch's global generator (R5), and the payload
   launch counts among the master-side mirrors (R2).
2. **Held to JAX** — each R1-R6 fixture written twice, in JAX's layout
   and in the port's: ``repro.analysis`` and ``repro_torch.analysis``
   give the same findings once ``repro`` is renamed ``repro_torch``.
3. **Why the port needs its own checker** — a blocking call planted in
   the port's async ``_drive`` is a finding for it and none for JAX's.
4. **The gate** — the real tree is clean under the port's baseline, and
   the CLI's exit codes and reports.
"""

import json
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from repro.analysis import run_analysis as jax_run_analysis
from repro.analysis.__main__ import main as jax_analysis_main
from repro_torch.analysis import (
    DEFAULT_BASELINE_PATH,
    RULES,
    apply_baseline,
    load_baseline,
    run_analysis,
)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.obs import ObsConfig
from repro_torch.obs.exporters import write_jsonl
from repro_torch.runtime.annotations import loop_only, worker_side
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.registry import get_scenario

REPO_ROOT = Path(__file__).resolve().parents[1]

#: The reference simulator R3 pins: one path in both layouts, since the
#: port's manifest pins the JAX package's file (the port has no copy).
REF = "src/repro/core/sim_reference.py"
#: A fixture file whose content is the pinned reference itself.
PINNED = object()

# ---------------------------------------------------------------------------
# The fixtures of tests/test_analysis.py, in JAX's layout: name -> (rules,
# files).  _port_layout moves each into the port's.
# ---------------------------------------------------------------------------

_R6_MANIFEST = (
    '{"schema_test": "tests/test_obs.py",\n'
    ' "events": {"msg.enqueued": ["msg_id", "image", "arrival"]}}\n'
)
_R6_TEST = 'def test_schema():\n    assert "msg.enqueued"\n'
_WALL_CLOCK_IN_CORE = "import time\ndef stamp():\n    return time.time()\n"

FIXTURES = {
    "r1_blocking_call_in_async": (["R1"], {
        "src/repro/runtime/mod.py": (
            "import time\n"
            "async def tick():\n"
            "    time.sleep(1.0)\n"
        ),
    }),
    "r1_loop_call_into_worker_side": (["R1"], {
        "src/repro/runtime/mod.py": (
            "from repro.runtime.annotations import worker_side\n"
            "@worker_side\n"
            "def grind():\n"
            "    pass\n"
            "async def tick():\n"
            "    grind()\n"
        ),
    }),
    "r1_annotated_deliberate_stall": (["R1"], {
        "src/repro/runtime/mod.py": (
            "import time\n"
            "from repro.runtime.annotations import loop_only\n"
            "@loop_only(blocking='teardown join after the clock stopped')\n"
            "def drain():\n"
            "    time.sleep(0.1)\n"
            "async def tick():\n"
            "    drain()\n"
        ),
    }),
    "r2_unannotated_mirror_mutation": (["R2"], {
        "src/repro/runtime/mod.py": "def poke(pe):\n    pe.state = 2\n",
    }),
    "r2_second_data_channel_consumer": (["R2"], {
        "src/repro/runtime/mod.py": (
            "def steal(data_q):\n"
            "    return data_q.get_nowait()\n"
        ),
    }),
    "r2_contradictory_annotations": (["R2"], {
        "src/repro/runtime/mod.py": (
            "from repro.runtime.annotations import loop_only, worker_side\n"
            "@loop_only\n"
            "@worker_side\n"
            "def confused():\n"
            "    pass\n"
        ),
    }),
    "r3_modified_frozen_file": (["R3"], {REF: "# a drive-by edit\n"}),
    "r3_import_outside_allowlist": (["R3"], {
        REF: PINNED,
        "src/repro/runtime/sneaky.py": (
            "from repro.core.sim_reference import simulate_reference\n"
        ),
    }),
    "r4_unregistered_field": (["R4"], {
        "src/repro/scenarios/streams.py": (
            "from dataclasses import dataclass\n"
            "@dataclass\n"
            "class Message:\n"
            "    image: str\n"
            "    duration: float\n"
            "    cpu_cores: float\n"
            "    arrival: float\n"
            "    resources: dict\n"
            "    msg_id: int\n"
            "    start_t: float\n"
            "    done_t: float\n"
            "    smuggled: bytes\n"
        ),
    }),
    "r4_stale_manifest_entry": (["R4"], {
        "src/repro/scenarios/streams.py": (
            "from dataclasses import dataclass\n"
            "@dataclass\n"
            "class Message:\n"
            "    image: str\n"
        ),
    }),
    "r5_wall_clock_read": (["R5"], {"src/repro/core/mod.py": _WALL_CLOCK_IN_CORE}),
    "r5_unseeded_rng_and_set_iteration": (["R5"], {
        "src/repro/core/mod.py": (
            "import numpy as np\n"
            "def draw(images):\n"
            "    rng = np.random.default_rng()\n"
            "    for img in set(images):\n"
            "        rng.random()\n"
        ),
    }),
    "r5_wall_clock_in_runtime_decision_logic": (["R5"], {
        "src/repro/runtime/policy.py": (
            "import time\n"
            "def decide():\n"
            "    return time.time()\n"
        ),
    }),
    "r5_annotated_measurement_sites_not_rng": (["R5"], {
        # the sanctioned wall-clock wrapper is allowlisted wholesale
        "src/repro/runtime/clock.py": (
            "import time\n"
            "def now():\n"
            "    return time.perf_counter()\n"
        ),
        # measurement affinity annotations and async loop code are exempt
        "src/repro/runtime/meas.py": (
            "import time\n"
            "from .annotations import loop_only, worker_side\n"
            "@worker_side\n"
            "def grind():\n"
            "    return time.perf_counter()\n"
            "@loop_only\n"
            "def poll():\n"
            "    return time.monotonic()\n"
            "async def drive():\n"
            "    return time.time()\n"
        ),
        # RNG gets no exemption anywhere, even under annotations
        "src/repro/obs/jitterbug.py": (
            "import random\n"
            "from repro.runtime.annotations import worker_side\n"
            "@worker_side\n"
            "def jitter():\n"
            "    return random.random()\n"
        ),
    }),
    "r6_unregistered_event_type": (["R6"], {
        "src/repro/obs/event_manifest.json": _R6_MANIFEST,
        "tests/test_obs.py": _R6_TEST,
        "src/repro/runtime/mod.py": (
            "def go(bus, m):\n"
            '    bus.emit("msg.enqueued", msg_id=m.msg_id, image=m.image,\n'
            "             arrival=m.arrival)\n"
            '    bus.emit("msg.mystery", msg_id=m.msg_id)\n'
        ),
    }),
    "r6_payload_field_drift": (["R6"], {
        "src/repro/obs/event_manifest.json": _R6_MANIFEST,
        "tests/test_obs.py": _R6_TEST,
        "src/repro/runtime/mod.py": (
            "def go(bus, m):\n"
            '    bus.emit("msg.enqueued", msg_id=m.msg_id, image=m.image,\n'
            "             priority=3)\n"
        ),
    }),
    # nothing emits msg.enqueued, and the schema test never names it
    "r6_stale_entry_and_unexercised_type": (["R6"], {
        "src/repro/obs/event_manifest.json": _R6_MANIFEST,
        "tests/test_obs.py": "def test_nothing():\n    pass\n",
        "src/repro/runtime/mod.py": "def go(bus):\n    pass\n",
    }),
    "r6_non_literal_event_type": (["R6"], {
        "src/repro/obs/event_manifest.json": _R6_MANIFEST,
        "tests/test_obs.py": _R6_TEST,
        "src/repro/runtime/mod.py": (
            "def go(bus, m, ev):\n"
            '    bus.emit("msg.enqueued", msg_id=m.msg_id, image=m.image,\n'
            "             arrival=m.arrival)\n"
            "    bus.emit(ev, msg_id=m.msg_id)\n"
        ),
    }),
    "unparseable_file": (["R5"], {"src/repro/core/broken.py": "def oops(:\n"}),
}

#: The names the JAX package's tree and messages use that the port's
#: differ in, beyond the package itself (``repro`` -> ``repro_torch``).
_RENAMES = (
    ("tests/test_obs.py", "tests/test_torch_obs.py"),
    ("tests/test_wire_contract.py", "tests/test_torch_wire_contract.py"),
    ("bus.emit site in src/ produces", "bus.emit site in src/repro_torch/ produces"),
)


def _renamed(text: str) -> str:
    """``text`` with the JAX package's names turned into the port's; the
    pinned reference's path is the same in both."""
    text = text.replace(REF, "\0")
    text = re.sub(r"\brepro(?=[./])", "repro_torch", text)
    for jax_name, port_name in _RENAMES:
        text = text.replace(jax_name, port_name)
    return text.replace("\0", REF)


def _write_tree(root: Path, files: dict) -> Path:
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if content is PINNED:
            shutil.copy(REPO_ROOT / REF, p)
        else:
            p.write_text(content, encoding="utf-8")
    return root


def _port_layout(files: dict) -> dict:
    return {_renamed(rel): content if content is PINNED else _renamed(content)
            for rel, content in files.items()}


def _port_run(tmp_path: Path, name: str):
    rules, files = FIXTURES[name]
    return run_analysis(_write_tree(tmp_path, _port_layout(files)), rules=rules)


def _messages(findings, rule):
    return [f.message for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# R1 — blocking-in-async
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r1_fires_on_blocking_call_in_async(tmp_path):
    found = _port_run(tmp_path, "r1_blocking_call_in_async")
    msgs = _messages(found, "R1")
    assert len(msgs) == 1
    assert "time.sleep" in msgs[0]
    assert found[0].symbol == "tick"
    assert found[0].path == "src/repro_torch/runtime/mod.py"


@pytest.mark.timeout(30)
def test_r1_fires_on_loop_call_into_worker_side(tmp_path):
    """The annotation vocabulary is enforced at call-graph boundaries: an
    edge from loop-reachable code into @worker_side is itself a finding."""
    msgs = _messages(_port_run(tmp_path, "r1_loop_call_into_worker_side"), "R1")
    assert len(msgs) == 1
    assert "@worker_side" in msgs[0] and "grind" in msgs[0]


@pytest.mark.timeout(30)
def test_r1_exempts_annotated_deliberate_stall(tmp_path):
    assert _messages(_port_run(tmp_path, "r1_annotated_deliberate_stall"), "R1") == []


@pytest.mark.timeout(30)
@pytest.mark.parametrize("call, label", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.synchronize(device)", "torch.cuda.synchronize()"),
    ("done.synchronize()", "done.synchronize()"),
])
def test_r1_fires_on_a_host_sync_in_async(tmp_path, call, label):
    """The torch idiom's host syncs block the loop until the device is done;
    the JAX package's checker does not know them."""
    files = {"src/repro/runtime/mod.py": (
        "import torch\n"
        "async def tick(device, done):\n"
        f"    {call}\n"
    )}
    found = run_analysis(_write_tree(tmp_path / "port", _port_layout(files)), rules=["R1"])
    msgs = _messages(found, "R1")
    assert len(msgs) == 1 and f"blocking call {label}" in msgs[0], msgs
    assert (found[0].symbol, found[0].line) == ("tick", 3)
    assert jax_run_analysis(_write_tree(tmp_path / "jax", files), rules=["R1"]) == []


@pytest.mark.timeout(30)
def test_r1_exempts_a_host_sync_on_the_worker_side(tmp_path):
    """The port's payload waits for the device in @worker_side code, where
    blocking is the point."""
    found = run_analysis(_write_tree(tmp_path, {"src/repro_torch/runtime/mod.py": (
        "import torch\n"
        "from .annotations import worker_side\n"
        "@worker_side\n"
        "def run_sync(end):\n"
        "    end.synchronize()\n"
        "    torch.cuda.synchronize()\n"
        "async def tick(loop, end):\n"
        "    await loop.run_in_executor(None, run_sync, end)\n"
    )}), rules=["R1"])
    assert found == []


# ---------------------------------------------------------------------------
# R2 — single-consumer / thread affinity
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r2_fires_on_unannotated_mirror_mutation(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r2_unannotated_mirror_mutation"), "R2")
    assert len(msgs) == 1
    assert "pe.state" in msgs[0] and "@loop_only" in msgs[0]


@pytest.mark.timeout(30)
def test_r2_fires_on_second_data_channel_consumer(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r2_second_data_channel_consumer"), "R2")
    assert len(msgs) == 1
    assert "single-consumer" in msgs[0]


@pytest.mark.timeout(30)
def test_r2_fires_on_contradictory_annotations(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r2_contradictory_annotations"), "R2")
    assert any("both @loop_only and @worker_side" in m for m in msgs)


@pytest.mark.timeout(30)
@pytest.mark.parametrize("target", ["h.kernel_launches = 0",
                                    "self.pool.payload_kernel_launches += 1"])
def test_r2_fires_on_launch_count_mirrors_worker_side(tmp_path, target):
    """The multiproc handles' payload launch counts and their sum are
    master-side mirrors, folded in on the loop thread only: a worker-side
    write is a finding, as is one outside @loop_only, and a @loop_only
    fold like the transport's ``_fold_launches`` is not."""
    recv, attr = target.split(" ")[0].rsplit(".", 1)
    found = run_analysis(_write_tree(tmp_path, {"src/repro_torch/runtime/mod.py": (
        "from .annotations import loop_only, worker_side\n"
        "@worker_side\n"
        "def grind(self, h):\n"
        f"    {target}\n"
        "def helper(self, h):\n"
        f"    {target}\n"
        "@loop_only\n"
        "def fold(self, h):\n"
        f"    {target}\n"
    )}), rules=["R2"])
    assert [(f.symbol, f.line) for f in found] == [("grind", 4), ("helper", 6)]
    assert f"@worker_side code mutates master-side mirror state ({recv}.{attr})" \
        in found[0].message
    assert f"mirror mutation {recv}.{attr} outside @loop_only" in found[1].message


# ---------------------------------------------------------------------------
# R3 — frozen-reference guard
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r3_fires_on_modified_frozen_file(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r3_modified_frozen_file"), "R3")
    assert any("frozen file modified" in m for m in msgs)
    assert any("re-pin the hash in src/repro_torch/analysis/frozen_manifest.json" in m
               for m in msgs)


@pytest.mark.timeout(30)
def test_r3_fires_on_import_outside_allowlist(tmp_path):
    found = _port_run(tmp_path, "r3_import_outside_allowlist")
    assert [f.path for f in found] == ["src/repro_torch/runtime/sneaky.py"]
    assert "allowlist" in found[0].message


@pytest.mark.timeout(30)
def test_r3_allows_no_port_file_to_import_the_reference(tmp_path):
    """The port's allowlist is empty: a port test importing the reference is
    a finding, where the JAX package's own equivalence suite is allowed."""
    found = run_analysis(_write_tree(tmp_path, {
        REF: PINNED,
        "tests/test_torch_sim_equivalence.py": (
            "from repro.core.sim_reference import simulate_reference\n"),
    }), rules=["R3"])
    assert [(f.path, f.line) for f in found] == [("tests/test_torch_sim_equivalence.py", 1)]


# ---------------------------------------------------------------------------
# R4 — wire-contract drift
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r4_fires_on_unregistered_field(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r4_unregistered_field"), "R4")
    assert any(
        "drift" in m and "'smuggled'" in m and "wire_manifest.json" in m
        and "tests/test_torch_wire_contract.py" in m
        for m in msgs
    )


@pytest.mark.timeout(30)
def test_r4_fires_on_stale_manifest_entry(tmp_path):
    """The inverse direction: a registered field the class no longer has."""
    msgs = _messages(_port_run(tmp_path, "r4_stale_manifest_entry"), "R4")
    assert any("stale wire manifest" in m and "duration" in m for m in msgs)


# ---------------------------------------------------------------------------
# R5 — determinism lint
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r5_fires_on_wall_clock_read(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r5_wall_clock_read"), "R5")
    assert len(msgs) == 1
    assert "wall-clock read time.time()" in msgs[0]


@pytest.mark.timeout(30)
def test_r5_fires_on_unseeded_rng_and_set_iteration(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r5_unseeded_rng_and_set_iteration"), "R5")
    assert any("unseeded default_rng()" in m for m in msgs)
    assert any("hash-order-dependent" in m for m in msgs)


@pytest.mark.timeout(30)
def test_r5_fires_on_wall_clock_in_runtime_decision_logic(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r5_wall_clock_in_runtime_decision_logic"), "R5")
    assert len(msgs) == 1
    assert "ScaledClock" in msgs[0]


@pytest.mark.timeout(30)
def test_r5_exempts_annotated_measurement_sites_not_rng(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r5_annotated_measurement_sites_not_rng"), "R5")
    assert len(msgs) == 1
    assert "global RNG" in msgs[0]


@pytest.mark.timeout(30)
@pytest.mark.parametrize("call, fires", [
    ("torch.randn(3)", True),
    ("torch.randn(3, generator=g)", False),
    ("torch.randint(0, 9, (4,))", True),
    ("torch.randperm(5, generator=g)", False),
    ("torch.bernoulli(x)", True),
    ("torch.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("g.manual_seed(0)", False),
])
def test_r5_torch_global_generator(tmp_path, call, fires):
    """torch's global generator is ambient RNG: its seeding calls wherever
    they sit, and its draws unless they are handed a generator."""
    found = run_analysis(_write_tree(tmp_path, {"src/repro_torch/core/mod.py": (
        "import torch\n"
        "def draw(g, x):\n"
        f"    return {call}\n"
    )}), rules=["R5"])
    name = call.split("(")[0]
    assert [(f.line, f.message) for f in found] == ([(
        3, f"torch global-state RNG {name}(); draw from a seeded torch.Generator "
           f"passed as generator=, or from a seeded default_rng")] if fires else [])


@pytest.mark.timeout(30)
def test_r5_allows_the_span_recorders_clock_and_no_other_in_obs(tmp_path):
    """``obs/spans.py`` stamps spans on the profiler's clock, the model
    path's one measurement clock: R5 stays quiet there and still fires on
    the same read elsewhere in ``obs/``."""
    clock = "import time\ndef stamp():\n    return time.time_ns()\n"
    found = run_analysis(_write_tree(tmp_path, {"src/repro_torch/obs/spans.py": clock,
                                                "src/repro_torch/obs/other.py": clock}),
                         rules=["R5"])
    assert [(f.path, f.line) for f in found] == [("src/repro_torch/obs/other.py", 3)]
    assert "wall-clock read time.time_ns()" in found[0].message


# ---------------------------------------------------------------------------
# R6 — event-schema manifest
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_r6_fires_on_unregistered_event_type(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r6_unregistered_event_type"), "R6")
    assert any(
        "'msg.mystery'" in m and "src/repro_torch/obs/event_manifest.json" in m
        and "tests/test_torch_obs.py" in m
        for m in msgs
    )


@pytest.mark.timeout(30)
def test_r6_fires_on_payload_field_drift(tmp_path):
    """Both directions: an emitted field the manifest lacks, and a
    manifest field the emit site dropped."""
    msgs = _messages(_port_run(tmp_path, "r6_payload_field_drift"), "R6")
    assert any("'priority'" in m and "drift" in m for m in msgs)
    assert any("'arrival'" in m and "full pinned field set" in m for m in msgs)


@pytest.mark.timeout(30)
def test_r6_fires_on_stale_entry_and_unexercised_type(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r6_stale_entry_and_unexercised_type"), "R6")
    assert any("stale event manifest" in m for m in msgs)
    assert any("never exercised by the schema test" in m for m in msgs)


@pytest.mark.timeout(30)
def test_r6_fires_on_non_literal_event_type(tmp_path):
    msgs = _messages(_port_run(tmp_path, "r6_non_literal_event_type"), "R6")
    assert any("non-literal event type" in m for m in msgs)


@pytest.mark.timeout(30)
def test_r6_reads_only_the_ports_emit_sites(tmp_path):
    """The JAX package's emit sites are held to the JAX manifest by
    ``repro.analysis``; the port's rule neither counts nor checks them."""
    rules, files = FIXTURES["r6_unregistered_event_type"]
    tree = _write_tree(tmp_path, {**_port_layout(files), **files})
    found = run_analysis(tree, rules=rules)
    assert {f.path for f in found} == {"src/repro_torch/runtime/mod.py"}


# ---------------------------------------------------------------------------
# Infrastructure: parse findings, baseline semantics, annotations
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_unparseable_file_is_a_finding_not_a_gap(tmp_path):
    found = _port_run(tmp_path, "unparseable_file")
    assert [(f.rule, f.path) for f in found] == [("parse", "src/repro_torch/core/broken.py")]


@pytest.mark.timeout(30)
def test_parse_failure_is_reported_once_with_the_protocol_rules(tmp_path):
    """R7 and R8 report an unparseable file when run alone; together with
    the walk's own report it is still one finding."""
    _write_tree(tmp_path, {"src/repro_torch/runtime/master.py": "def oops(:\n"})
    found = run_analysis(tmp_path, rules=["R5", "R7", "R8"])
    assert [f.path for f in found if f.rule == "parse"] == ["src/repro_torch/runtime/master.py"]


@pytest.mark.timeout(30)
def test_baseline_suppresses_by_key_and_reports_stale(tmp_path):
    _write_tree(tmp_path, {"src/repro_torch/core/mod.py": _WALL_CLOCK_IN_CORE})
    found = run_analysis(tmp_path, rules=["R5"])
    assert len(found) == 1
    entry = {
        "rule": found[0].rule,
        "path": found[0].path,
        "symbol": found[0].symbol,
        "message": found[0].message,
    }
    active, suppressed, stale = apply_baseline(found, [entry])
    assert active == [] and len(suppressed) == 1 and stale == []
    # a suppression whose finding is gone must surface as stale
    active, suppressed, stale = apply_baseline([], [entry])
    assert stale == [entry]


@pytest.mark.timeout(30)
def test_annotations_are_transparent_identity_decorators():
    @worker_side
    def a():
        return 1

    @loop_only
    def b():
        return 2

    @loop_only(blocking="why")
    def c():
        return 3

    assert (a(), b(), c()) == (1, 2, 3)
    assert a.__worker_side__ and b.__loop_only__ and c.__loop_only__
    assert c.__loop_blocking_reason__ == "why"


# ---------------------------------------------------------------------------
# Held to JAX: the same findings on the same tree in either layout
# ---------------------------------------------------------------------------


def _as_tuple(f, rename=lambda s: s):
    return (f.rule, rename(f.path), f.line, f.symbol, rename(f.message))


@pytest.mark.timeout(30)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_findings_equal_the_jax_checkers(tmp_path, name):
    rules, files = FIXTURES[name]
    jax = jax_run_analysis(_write_tree(tmp_path / "jax", files), rules=rules)
    port = run_analysis(_write_tree(tmp_path / "port", _port_layout(files)), rules=rules)
    assert sorted(_as_tuple(f) for f in port) == sorted(_as_tuple(f, _renamed) for f in jax)
    # the allowed-stall fixture is the one meant to come out clean
    assert bool(port) == (name != "r1_annotated_deliberate_stall")


# ---------------------------------------------------------------------------
# The reason for the port's checker: a blocking call in the port's _drive
# ---------------------------------------------------------------------------

_DRIVE_ANCHOR = "    clock = ScaledClock(rt.time_scale)\n"


@pytest.mark.timeout(60)
def test_blocking_call_in_the_ports_drive_is_found_by_the_port_only(tmp_path, capsys):
    for pkg in ("repro", "repro_torch"):
        for sub in ("runtime", "core"):
            shutil.copytree(REPO_ROOT / "src" / pkg / sub, tmp_path / "src" / pkg / sub,
                            ignore=shutil.ignore_patterns("__pycache__"))
    live = tmp_path / "src/repro_torch/runtime/live.py"
    text = live.read_text(encoding="utf-8")
    assert "\nimport time\n" in text and text.count(_DRIVE_ANCHOR) == 1
    head, tail = text.split(_DRIVE_ANCHOR)
    assert head.rstrip().endswith("-> SimResult:")  # the anchor opens _drive
    live.write_text(head + "    time.sleep(0.0)\n" + _DRIVE_ANCHOR + tail, encoding="utf-8")
    planted = head.count("\n") + 1

    found = run_analysis(tmp_path, rules=["R1"])
    assert [(f.path, f.line, f.symbol) for f in found] == [
        ("src/repro_torch/runtime/live.py", planted, "_drive")]
    assert "blocking call time.sleep reachable from async code" in found[0].message
    assert jax_run_analysis(tmp_path, rules=["R1"]) == []

    assert analysis_main(["--root", str(tmp_path), "--rules", "R1"]) == 1
    assert f"live.py:{planted}: [R1] _drive: blocking call time.sleep" in capsys.readouterr().out
    assert jax_analysis_main(["--root", str(tmp_path), "--rules", "R1"]) == 0
    assert "analysis clean" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The gate: the real tree is clean under the port's baseline
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_real_tree_is_clean():
    findings = run_analysis(REPO_ROOT)
    suppressions = load_baseline(REPO_ROOT / DEFAULT_BASELINE_PATH)
    assert suppressions == []  # the port's baseline ships empty
    active, _, stale = apply_baseline(findings, suppressions)
    details = "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in active
    )
    assert not active, (
        f"invariant violations in the port (fix them, with a test):\n{details}"
    )
    assert not stale, f"stale baseline suppressions: {stale}"


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_cli_exit_codes_and_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = analysis_main([
        "--root", str(REPO_ROOT), "--format", "json", "--out", str(out),
    ])
    capsys.readouterr()
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True
    assert set(report["rules"]) == set(RULES) == {f"R{i}" for i in range(1, 9)}
    assert report["findings"] == [] and report["stale_suppressions"] == []
    assert str(REPO_ROOT) not in out.read_text() and report["root"] == "."

    assert analysis_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == list(RULES)

    assert analysis_main(["--root", str(REPO_ROOT), "--rules", "R9"]) == 2
    assert "unknown rules ['R9']" in capsys.readouterr().err
    assert analysis_main(["--root", str(tmp_path)]) == 2  # no src/repro_torch
    capsys.readouterr()


@pytest.mark.timeout(60)
def test_cli_rules_subset_and_text_report(tmp_path, capsys):
    _write_tree(tmp_path, {"src/repro_torch/core/mod.py": _WALL_CLOCK_IN_CORE})
    assert analysis_main(["--root", str(tmp_path), "--rules", "R1,R2"]) == 0
    assert "analysis clean" in capsys.readouterr().out
    assert analysis_main(["--root", str(tmp_path), "--rules", "R5"]) == 1
    out = capsys.readouterr().out
    assert "src/repro_torch/core/mod.py:3: [R5] wall-clock read time.time()" in out
    assert "1 finding(s)" in out

    # a suppression in the port's baseline silences it; a stale one fails
    found = run_analysis(tmp_path, rules=["R5"])
    entry = {k: getattr(found[0], k) for k in ("rule", "path", "symbol", "message")}
    baseline = tmp_path / DEFAULT_BASELINE_PATH
    baseline.parent.mkdir(parents=True, exist_ok=True)
    baseline.write_text(json.dumps({"suppressions": [entry]}), encoding="utf-8")
    assert analysis_main(["--root", str(tmp_path), "--rules", "R5"]) == 0
    capsys.readouterr()
    (tmp_path / "src/repro_torch/core/mod.py").write_text("x = 1\n", encoding="utf-8")
    assert analysis_main(["--root", str(tmp_path), "--rules", "R5"]) == 1
    assert "stale suppression" in capsys.readouterr().out


@pytest.fixture(scope="module")
def sim_log(tmp_path_factory):
    """The port's sim on the microscopy smoke scenario, its bus written out."""
    scn = get_scenario("microscopy")
    res = run_scenario("microscopy", policy="first-fit", n_runs=1,
                       stream_overrides=scn.smoke_overrides, t_max=scn.smoke_t_max,
                       obs=ObsConfig(level="lifecycle"))
    log = tmp_path_factory.mktemp("sim") / "events.jsonl"
    write_jsonl(log, res.obs.events)
    return log, res.obs.events


@pytest.mark.timeout(120)
def test_cli_events_over_a_clean_and_a_tampered_log(tmp_path, capsys, sim_log):
    log, events = sim_log
    assert analysis_main(["--root", str(REPO_ROOT), "--rules", "R8",
                          "--events", str(log)]) == 0
    assert "analysis clean" in capsys.readouterr().out

    # a second completion of a message already completed
    done = next(i for i, e in enumerate(events) if e["ev"] == "msg.completed")
    tampered = events[:done + 1] + [dict(events[done])] + events[done + 1:]
    bad = tmp_path / "bad" / "events.jsonl"
    bad.parent.mkdir()
    write_jsonl(bad, tampered)
    rc = analysis_main(["--root", str(REPO_ROOT), "--rules", "R8", "--format", "json",
                        "--events", str(log), "--events", str(bad.parent)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and report["ok"] is False
    assert {f["rule"] for f in report["findings"]} == {"R8"}
    assert {f["path"] for f in report["findings"]} == {str(bad)}
    assert any("duplicate completion" in f["message"] for f in report["findings"])


def _git(cwd, *argv):
    subprocess.run(
        ["git", "-c", "user.email=t@example.com", "-c", "user.name=t",
         *argv],
        cwd=cwd, check=True, capture_output=True,
    )


@pytest.mark.timeout(60)
def test_changed_only_reports_only_changed_files(tmp_path, capsys):
    _write_tree(tmp_path, {"src/repro_torch/core/old.py": _WALL_CLOCK_IN_CORE})
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-q", "-m", "seed")

    # nothing changed vs HEAD → the committed violation is out of scope
    rc = analysis_main(["--root", str(tmp_path), "--rules", "R5",
                        "--changed-only"])
    capsys.readouterr()
    assert rc == 0

    # an untracked file with a violation is in scope
    _write_tree(tmp_path, {"src/repro_torch/core/new.py": _WALL_CLOCK_IN_CORE})
    rc = analysis_main(["--root", str(tmp_path), "--rules", "R5",
                        "--changed-only"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "new.py" in out and "old.py" not in out


@pytest.mark.timeout(60)
def test_changed_only_outside_a_git_repo_is_a_usage_error(tmp_path, capsys):
    _write_tree(tmp_path, {"src/repro_torch/core/mod.py": "x = 1\n"})
    rc = analysis_main(["--root", str(tmp_path), "--rules", "R5",
                        "--changed-only"])
    capsys.readouterr()
    assert rc == 2
