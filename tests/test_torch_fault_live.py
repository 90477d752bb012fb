"""At-least-once under churn on the port's live runtime: random worker
kills on ``repro_torch.runtime.run_live``, the mirror of
``tests/test_fault_live.py::test_random_kill_times_never_lose_or_duplicate_messages``
(the same seed, draws and trials).

Kill times and victims are drawn from a seeded RNG over the window where
the microscopy pool is busiest.  Loss would show up as ``completed <
total``; duplication as ``completed > total`` or a completion recorded for
a message the master also still holds.  Both are asserted per run.
``examples/torch_fault_tolerance.py`` scenario 3 runs on this path.

Under six test workers the reference's trial 3 (worker 0 killed at 52.1 s)
sometimes ended 39/40: the kill took the only PE of the image, and the one
requeued message, with the load predictor in its cooldown, was below every
trigger, so no PE was asked for again until the run gave up on it; and a
PE asked for went to the dead worker's slot, which the packer saw empty,
until its TTL ran out.  The port asks for a PE while such a message waits
with none to take it (``runtime.live._fail_over``) and reports a failed
slot as a full bin; the trial is kept below as a fixed case, beside the
rule itself.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.core.irm import IRM, IRMConfig
from repro_torch.core.queues import HostRequest
from repro_torch.core.workloads import Message
from repro_torch.runtime import RuntimeConfig, run_live
from repro_torch.runtime.live import _fail_over
from repro_torch.runtime.master import Master
from repro_torch.scenarios.registry import get_scenario

FAST = RuntimeConfig(time_scale=0.005)


def _run_with_kill(worker_idx: int, kill_t: float):
    scn = get_scenario("microscopy")
    cfg = dataclasses.replace(
        scn.sim_config(),
        t_max=scn.smoke_t_max,
        fail_worker_at=(worker_idx, float(kill_t)),
    )
    stream = scn.make_stream(0, **scn.smoke_overrides)
    return run_live(stream, cfg, runtime=FAST)


@pytest.mark.timeout(300)
def test_random_kill_times_never_lose_or_duplicate_messages():
    rng = np.random.default_rng(11)
    for trial in range(4):
        kill_t = float(rng.uniform(15.0, 55.0))
        worker_idx = int(rng.integers(0, 2))
        res = _run_with_kill(worker_idx, kill_t)
        label = f"trial {trial}: kill worker {worker_idx} @ {kill_t:.1f}s"
        # exactly-total completions: < total is loss, > total is a
        # duplicate completion slipping past the drain accounting
        assert res.completed == res.total, label
        # every stream message really finished (bijective completion)
        assert all(m.done_t >= 0.0 for m in res.messages), label
        # a processed-then-requeued message keeps only its final stamps
        assert all(m.done_t > m.start_t >= 0.0 for m in res.messages), label
        assert res.requeued >= 0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", range(3))
def test_a_kill_of_the_last_pe_near_the_end_still_completes(run):
    """The reference's trial 3, fixed: worker 0 killed at 52.1 s, near the
    end of the stream, where it may hold the image's last PE."""
    res = _run_with_kill(0, 52.12844091841478)
    assert res.completed == res.total == 40
    assert all(m.done_t > m.start_t >= 0.0 for m in res.messages)


class _Worker:
    def __init__(self, *images):
        self.pes = [type("PE", (), {"image": img})() for img in images]


class _Pool:
    def __init__(self, *workers):
        self.workers = list(workers)


@pytest.mark.parametrize("hosted,asked,want", [
    ((), (), 1), (("img-a",), (), 0), (("img-b",), (), 1), ((), ("img-a",), 0)])
def test_fail_over_asks_for_a_pe_only_where_none_is_left(hosted, asked, want):
    """A requeued message's image that no surviving PE hosts, and that no
    request in the IRM's queues asks for, gets one PE request."""
    irm = IRM(IRMConfig())
    for image in asked:
        irm.container_queue.push(HostRequest(image=image))
    master = Master(total_expected=2)
    master.push_back(Message(image="img-a", duration=5.0))
    assert not _fail_over(irm, _Pool(), master, 1.0)  # nothing requeued: nothing asked
    master.requeue(master.pull("img-a"))
    assert _fail_over(irm, _Pool(_Worker(*hosted), _Worker()), master, 52.5)
    reqs = [r for r in irm.container_queue.drain(10) if r.source == "failover"]
    assert [(r.image, r.enqueue_time) for r in reqs] == [("img-a", 52.5)] * want
