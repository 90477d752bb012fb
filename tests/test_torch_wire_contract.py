"""Wire contract of the port: everything its multiproc transport ships
must pickle.

The JAX package's ``tests/test_wire_contract.py``, case for case, on the
port's classes: this is the contract test that rule R4 of ``python -m
repro_torch.analysis`` names (``src/repro_torch/analysis/wire_manifest.json``),
so every registered field appears here.

``runtime.transport.MultiprocTransport`` moves ``Message`` payloads to
worker OS processes and back through pickled queue frames
(``Transport.serialize`` / ``deserialize``).  These tests pin the
serialization contract for every type that crosses — or could cross — the
process boundary: ``Message`` (including numpy-influenced float fields and
the auxiliary ``resources`` dict), ``Resources`` (a ``__slots__`` class
backed by a float64 ndarray), and ``HostRequest`` (whose
``size_estimate`` may be a ``Resources`` vector).  It also pins the one
*semantic* property serialization must not disturb: the master's
negative-sequence head-requeue ordering, exercised with messages that
have been round-tripped through the wire format.
"""

import asyncio
import pickle

import numpy as np
import pytest

from repro_torch.core.queues import HostRequest
from repro_torch.core.resources import Resources
from repro_torch.core.workloads import Message
from repro_torch.runtime.master import Master
from repro_torch.runtime.transport import InProcTransport, MultiprocTransport


def _roundtrip(obj, transport=None):
    if transport is None:
        return pickle.loads(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))
    return transport.deserialize(transport.serialize(obj))


# ---------------------------------------------------------------------------
# Message
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_message_roundtrip_scalar():
    m = Message(image="img/a", duration=12.5, cpu_cores=1.25, arrival=3.0)
    m.start_t = 7.5
    r = _roundtrip(m)
    assert r is not m
    assert r.image == m.image
    assert r.duration == m.duration
    assert r.cpu_cores == m.cpu_cores
    assert r.arrival == m.arrival
    assert r.msg_id == m.msg_id
    assert r.start_t == 7.5 and r.done_t == -1.0
    assert r.resources is None


@pytest.mark.timeout(30)
def test_message_roundtrip_numpy_backed_fields():
    """Stream generators fill duration/cpu_cores from numpy RNG draws:
    np.float64 scalars must survive as exact doubles, and an auxiliary
    ``resources`` dict with numpy values must come back equal."""
    rng = np.random.default_rng(0)
    dur = rng.uniform(10.0, 20.0)            # np.float64
    cores = rng.normal(1.0, 0.1)
    m = Message(image="img/np", duration=dur, cpu_cores=cores,
                resources={"mem": float(rng.uniform(0.2, 0.5)),
                           "accel": 0.0})
    r = _roundtrip(m)
    assert float(r.duration) == float(dur)
    assert float(r.cpu_cores) == float(cores)
    assert r.resources == m.resources
    assert set(r.resources) == {"mem", "accel"}


@pytest.mark.timeout(30)
def test_message_roundtrip_via_transport_hooks():
    """Both transports expose the same serialize/deserialize hooks and the
    multiproc one accounts for them; the blob is plain pickle either way."""
    m = Message(image="img/hook", duration=5.0)
    for tr in (InProcTransport(), MultiprocTransport()):
        r = _roundtrip(m, transport=tr)
        assert r.msg_id == m.msg_id and r.image == m.image


# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_resources_roundtrip_preserves_dims_dtype_values():
    res = Resources(("cpu", "mem", "accel"), (0.25, 0.5, 0.0))
    r = _roundtrip(res)
    assert r.dims == ("cpu", "mem", "accel")
    assert r.values.dtype == np.float64
    assert r.values.shape == (3,)
    np.testing.assert_array_equal(r.values, res.values)
    # the copy is independent: value semantics survive the boundary
    assert r.values is not res.values


@pytest.mark.timeout(30)
def test_resources_roundtrip_arithmetic_identity():
    """Exact IEEE-754 doubles: packing math on a round-tripped vector must
    be bit-identical to packing math on the original (the profiler and
    allocator never see 'almost' the same estimate after a hop)."""
    a = Resources(("cpu", "mem"), (1.0 / 3.0, 0.7))
    b = _roundtrip(a)
    assert (a + b).values.tolist() == (a + a).values.tolist()
    assert _roundtrip(Resources.cpu(0.125)).get("cpu") == 0.125


# ---------------------------------------------------------------------------
# HostRequest
# ---------------------------------------------------------------------------


@pytest.mark.timeout(30)
def test_host_request_roundtrip_scalar_estimate():
    req = HostRequest(image="img/a", size_estimate=0.4, ttl=2,
                      target_worker=3, meta={"k": 1})
    r = _roundtrip(req)
    assert (r.image, r.size_estimate, r.ttl, r.target_worker) == \
        ("img/a", 0.4, 2, 3)
    assert r.req_id == req.req_id
    assert r.meta == {"k": 1}


@pytest.mark.timeout(30)
def test_host_request_roundtrip_queueing_fields():
    """``enqueue_time`` (admission stamp) and ``source`` ("autoscale" |
    "user" provenance) must survive the hop so a request that bounces off
    a still-booting worker keeps its original admission time and origin
    through the TTL-requeue loop."""
    req = HostRequest(image="img/t", size_estimate=0.2, ttl=1,
                      enqueue_time=42.5, source="user")
    r = _roundtrip(req)
    assert r.enqueue_time == 42.5
    assert r.source == "user"
    # defaults survive too: a fresh request round-trips as fresh
    fresh = _roundtrip(HostRequest(image="img/t", size_estimate=0.2))
    assert fresh.enqueue_time == 0.0
    assert fresh.source == "autoscale"


@pytest.mark.timeout(30)
def test_host_request_roundtrip_vector_estimate():
    est = Resources(("cpu", "mem"), (0.3, 0.45))
    req = HostRequest(image="img/v", size_estimate=est)
    r = _roundtrip(req)
    assert isinstance(r.size_estimate, Resources)
    assert r.size_estimate.dims == est.dims
    np.testing.assert_array_equal(r.size_estimate.values, est.values)


# ---------------------------------------------------------------------------
# Negative-seq requeue ordering across the wire
# ---------------------------------------------------------------------------


def _drain_image(master, image):
    out = []
    while True:
        m = master.pull(image)
        if m is None:
            return out
        out.append(m)


@pytest.mark.timeout(30)
def test_requeue_ordering_survives_serialization():
    """A failed worker's in-flight messages come back through the data
    queue as pickled frames, then re-enter the master at the *head*
    (negative seqs).  Whatever serialization did to the objects, the pull
    order must be: head re-inserts in reverse harvest order (insert(0, m)
    semantics), then the untouched FIFO tail."""

    async def scenario():
        master = Master(total_expected=6)
        originals = [Message(image="img/a", duration=float(i), arrival=0.0)
                     for i in range(6)]
        for m in originals:
            master.push_back(m)
        # two PEs pull the global head pair; the master now tracks them
        a = master.pull("img/a")
        b = master.pull("img/a")
        assert (a.duration, b.duration) == (0.0, 1.0)
        # the worker dies: the harvest crosses the wire as pickle frames
        harvest = [pickle.loads(pickle.dumps(m, pickle.HIGHEST_PROTOCOL))
                   for m in (a, b)]
        for m in harvest:
            master.requeue(m)
        assert master.requeued == 2
        order = [m.duration for m in _drain_image(master, "img/a")]
        # reverse harvest order at the head (b then a reversed → a, b? no:
        # appendleft(a) then appendleft(b) ⇒ b is the new global head)
        assert order == [1.0, 0.0, 2.0, 3.0, 4.0, 5.0]

    asyncio.run(scenario())


@pytest.mark.timeout(30)
def test_requeue_seq_numbers_stay_negative_and_decreasing():
    """The head re-insert contract the backlog observers rely on: each
    requeue takes the next *decreasing* negative sequence number even when
    the message object is a deserialized copy."""

    async def scenario():
        master = Master(total_expected=3)
        for i in range(3):
            master.push_back(Message(image="x", duration=float(i)))
        pulled = [master.pull("x") for _ in range(3)]
        for m in pulled:
            master.requeue(_roundtrip(m))
        dq = master._img_queues["x"]
        seqs = [s for s, _ in dq]
        assert seqs == [-3, -2, -1]
        assert all(s < 0 for s in seqs)
        # requeue cleared the start stamps (at-least-once restart)
        assert all(m.start_t == -1.0 for _, m in dq)

    asyncio.run(scenario())
