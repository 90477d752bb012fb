"""The span and counter recorder (``repro_torch.obs.spans``) and the spans
the train step and prefill record with it.

Recording follows a ``torch.profiler`` session: outside one nothing is
recorded and nothing is put into the autograd graph; inside one a train
step records ``train.step`` over ``train.forward``, ``train.cross_entropy``,
``train.backward`` (over ``train.cross_entropy.bwd``, whose parent is the
forward's span) and ``train.adamw``, and leaves every number as it was; a
prefill records ``prefill`` over its plan, layers and logits, and counts
the positions its layers compute, the tokens among them and whether it
packed them.
"""

import contextlib
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params
from repro_torch.models.params import tree_leaves
from repro_torch.obs import spans
from repro_torch.serving.kv_cache import PagedCacheLayout
from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

TRAIN_CHILDREN = {"train.forward", "train.cross_entropy", "train.backward", "train.adamw"}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("olmo-1b").smoke()
    m = build_model(cfg)
    return cfg, m, init_params(m.param_specs(), torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.drain()
    yield
    spans.drain()


def train_batch(cfg, B=2, S=64, seed=0):
    """Rows of two packed documents each, the second row's last 8 slots
    padding."""
    r = np.random.default_rng(seed)
    tokens = torch.from_numpy(r.integers(1, cfg.vocab_size, (B, S)))
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[:, 40:] = 2
    seg[-1, S - 8:] = 0
    pos = torch.cat([torch.arange(40), torch.arange(S - 40)]).repeat(B, 1).int()
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    labels[seg == 0] = -1
    return {"tokens": tokens, "labels": labels, "segment_ids": seg, "positions": pos}


def prefill_inputs(cfg, lens, seed=1):
    """A ragged batch: row b holds ``lens[b]`` tokens, padded to the
    longest."""
    B, S = len(lens), max(lens)
    r = np.random.default_rng(seed)
    tokens = torch.zeros(B, S, dtype=torch.int64)
    seg = torch.zeros(B, S, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = torch.from_numpy(r.integers(1, cfg.vocab_size, n))
        seg[b, :n], pos[b, :n] = 1, torch.arange(n)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def paged_cache(m, cfg, page_size=8):
    layout = PagedCacheLayout(num_pages=32, page_size=page_size, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim_, max_pages_per_seq=16)
    return m.init_paged_cache(layout, dtype=torch.float32)


def traced(fn):
    """``fn()`` under a CPU profiler session, and the records it left."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, spans.drain()


def by_name(records):
    return {r.name: r for r in records if isinstance(r, spans.Span)}


# ---------------------------------------------------------------------------
# Off: nothing recorded, nothing inserted
# ---------------------------------------------------------------------------


def test_nothing_is_recorded_without_a_profiler_session(model):
    cfg, m, params = model
    step = make_train_step(m, OptimizerConfig())
    step(params, init_opt_state(params), train_batch(cfg))
    m.prefill(params, prefill_inputs(cfg, [5, 12, 9]), paged_cache(m, cfg))
    spans.count("prefill.tokens", 3)
    assert spans.drain() == []
    assert spans.span("a") is spans.span("b", mark=torch.zeros(1))  # one shared null context


def test_the_loss_graph_holds_no_span_function_when_off(model):
    cfg, m, params = model
    wrt = {k: v for k, v in params.items()}
    wrt["embed"] = params["embed"].detach().requires_grad_(True)
    loss, _ = m.loss(wrt, train_batch(cfg))
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    assert not any("OnGrad" in type(fn).__name__ for fn in seen)


# ---------------------------------------------------------------------------
# On: the train step
# ---------------------------------------------------------------------------


def test_a_train_step_records_its_spans_nested_under_one_step(model):
    cfg, m, params = model
    step = make_train_step(m, OptimizerConfig())
    _, recs = traced(lambda: step(params, init_opt_state(params), train_batch(cfg)))
    got = by_name(recs)
    assert set(got) == {"train.step", "train.cross_entropy.bwd"} | TRAIN_CHILDREN
    assert len(recs) == len(got)  # one of each
    root = got["train.step"]
    assert root.parent is None and {r.step for r in recs} == {root.step}
    for name in TRAIN_CHILDREN:
        assert got[name].parent == root.id, name
        assert root.start_ns <= got[name].start_ns <= got[name].end_ns <= root.end_ns, name
    bwd, fwd = got["train.cross_entropy.bwd"], got["train.cross_entropy"]
    grad = got["train.backward"]
    assert bwd.parent == fwd.id
    assert grad.start_ns <= bwd.start_ns <= bwd.end_ns <= grad.end_ns
    order = ["train.forward", "train.cross_entropy", "train.backward", "train.adamw"]
    assert all(got[a].end_ns <= got[b].start_ns for a, b in zip(order, order[1:]))


def test_each_step_takes_its_own_id(model):
    cfg, m, params = model
    step = make_train_step(m, OptimizerConfig())

    def two():
        p, o, _ = step(params, init_opt_state(params), train_batch(cfg))
        step(p, o, train_batch(cfg, seed=1))
    _, recs = traced(two)
    roots = [r for r in recs if r.name == "train.step"]
    assert len(roots) == 2 and roots[0].step != roots[1].step
    for root in roots:
        assert sum(r.step == root.step for r in recs) == 6


@pytest.mark.parametrize("compute_dtype, microbatches",
                         [(torch.bfloat16, 1), (torch.float32, 1), (torch.float32, 2)])
def test_recording_leaves_params_state_and_loss_bit_identical(model, compute_dtype,
                                                             microbatches):
    cfg, m, params = model
    step = make_train_step(m, OptimizerConfig(learning_rate=1e-3), compute_dtype=compute_dtype,
                           microbatches=microbatches)
    batch = train_batch(cfg)
    off = step(params, init_opt_state(params), batch)
    on, recs = traced(lambda: step(params, init_opt_state(params), batch))
    assert sum(r.name == "train.cross_entropy.bwd" for r in recs) == microbatches
    for tree in (0, 1):  # params, optimizer state
        for a, b in zip(tree_leaves(off[tree]), tree_leaves(on[tree]), strict=True):
            assert torch.equal(a, b)
    assert torch.equal(off[2]["loss"], on[2]["loss"])
    assert torch.equal(off[2]["grad_norm"], on[2]["grad_norm"])


def test_a_mesh_train_step_records_its_spans_through_dtensors(model):
    """The profiled mesh steps (chip_smoke's phase 11b): the cross-entropy's
    backward span passes DTensors through, and the step is unchanged."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.context import activation_sharding
    from repro_torch.distributed.sharding import (
        batch_shardings,
        distribute,
        make_rules,
        param_shardings,
    )
    from repro_torch.models import make_batch
    from repro_torch.models.params import tree_map

    cfg, m, params = model
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        p_shard = param_shardings(m.param_specs(), mesh, rules)
        batch = make_batch(cfg, "train", 4, 32)
        b_shard = batch_shardings(batch, mesh, rules)
        dparams = tree_map(distribute, params, p_shard)
        dbatch = {k: distribute(v, b_shard[k]) for k, v in batch.items()}
        step = make_train_step(m, OptimizerConfig(), grad_shardings=p_shard,
                               compute_dtype=torch.float32)
        with activation_sharding(mesh, rules), implicit_replication():
            off = step(dparams, init_opt_state(dparams), dbatch)
            on, recs = traced(lambda: step(dparams, init_opt_state(dparams), dbatch))
    finally:
        dist.destroy_process_group()
    assert set(by_name(recs)) == {"train.step", "train.cross_entropy.bwd"} | TRAIN_CHILDREN
    assert torch.equal(off[2]["loss"].to_local(), on[2]["loss"].to_local())
    for a, b in zip(tree_leaves(off[0]), tree_leaves(on[0]), strict=True):
        assert torch.equal(a.to_local(), b.to_local())


# ---------------------------------------------------------------------------
# On: prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens", [[5, 12, 9], [16, 16], [1]])
def test_a_prefill_counts_its_positions_and_tokens(model, lens):
    """The positions the layers compute: the valid tokens of ragged rows,
    which prefill packs into one row (``prefill.packed``), else B x S."""
    cfg, m, params = model
    batch = prefill_inputs(cfg, lens)
    _, recs = traced(lambda: m.prefill(params, batch, paged_cache(m, cfg)))
    counts = {r.name: r.value for r in recs if isinstance(r, spans.Count)}
    ragged = len(set(lens)) > 1
    want = {"prefill.positions": sum(lens) if ragged else len(lens) * max(lens),
            "prefill.tokens": sum(lens)}
    assert counts == (dict(want, **{"prefill.packed": 1}) if ragged else want)
    got = by_name(recs)
    root = got["prefill"]
    assert set(got) == {"prefill", "prefill.plan", "prefill.layers", "prefill.logits"}
    for name in ("prefill.plan", "prefill.layers", "prefill.logits"):
        assert got[name].parent == root.id and got[name].step == root.step
    plan = got["prefill.plan"]
    assert all(plan.start_ns <= c.t_ns <= plan.end_ns
               for c in recs if isinstance(c, spans.Count))


def test_a_prefill_gives_the_same_logits_and_cache_recorded(model):
    cfg, m, params = model
    batch = prefill_inputs(cfg, [5, 12, 9])
    off_logits, off_cache = m.prefill(params, batch, paged_cache(m, cfg))
    (on_logits, on_cache), _ = traced(lambda: m.prefill(params, batch, paged_cache(m, cfg)))
    assert torch.equal(off_logits, on_logits)
    assert torch.equal(off_cache["k"], on_cache["k"]) and torch.equal(off_cache["v"], on_cache["v"])


# ---------------------------------------------------------------------------
# The recorder itself
# ---------------------------------------------------------------------------


def test_drain_empties_the_buffer():
    def record():
        with spans.span("outer"):
            spans.count("n", 2)
    _, recs = traced(record)
    assert [r.name for r in recs] == ["n", "outer"]
    assert spans.drain() == []


def test_a_span_on_another_thread_names_its_parent():
    """A plain thread does not inherit the session's recording, so the
    child is opened as autograd's device thread opens the backward's span:
    given, and with its parent named."""
    def record():
        with spans.span("outer") as outer:
            with spans.span("inner"):
                pass
            child = spans._Open("elsewhere", None, outer)
            t = threading.Thread(target=lambda: (child.start(), child.stop()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        return outer
    _, recs = traced(record)
    got = by_name(recs)
    assert got["inner"].parent == got["outer"].id
    assert got["elsewhere"].parent == got["outer"].id
    assert got["elsewhere"].step == got["outer"].step
    assert got["elsewhere"].thread != got["outer"].thread == got["inner"].thread


def test_a_span_marked_on_the_cpu_launches_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda *a: (_ for _ in ()).throw(AssertionError("launched")))
    _, recs = traced(lambda: spans.span("x", mark=torch.ones(2)).__enter__().stop())
    assert [(r.name, r.marks) for r in recs] == [("x", None)]


def test_marked_spans_number_their_markers_in_launch_order(monkeypatch):
    """Each marked span launches one marker at its start and one at its end,
    and keeps their indices: nested spans' markers bracket in stream
    order, and an unmarked span launches none."""
    launched = []
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))

    def record():
        with spans.span("outer", mark=on_card):
            with spans.span("inner", mark=on_card):
                with spans.span("host"):
                    pass
    _, recs = traced(record)
    got = by_name(recs)
    k = got["outer"].marks[0]
    assert got["outer"].marks == (k, k + 3) and got["inner"].marks == (k + 1, k + 2)
    assert got["host"].marks is None
    assert launched == [0, 0, 0, 0]
