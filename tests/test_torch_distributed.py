"""The port's distributed layer on the CPU against the JAX package's.

  - the sharding rules: the port's spec of every parameter leaf of the ten
    architectures at full width equals JAX's ``PartitionSpec`` on an
    ``AbstractMesh`` of the production shapes, in the three layouts (specs
    only, nothing allocated); the JAX package's pure-rule tests, the batch
    and cache rules;
  - ``GradCompressor``: ``stochastic=False`` bit for bit against JAX's over
    five calls carrying the error feedback; the JAX package's compressor
    tests, mirrored;
  - the train step with the compressor against JAX's (olmo-1b smoke);
  - the ``fake`` backend: DTensor placements on 256 and 512 ranks, local
    shard shapes as JAX's specs imply; the kernel wrappers' DTensor rule;
  - four gloo ranks on a (2, 2) mesh, in a subprocess: one train step with
    DTensor params and ``constrain`` active against the single-process port,
    and the MoE layer's G = 2 dispatch groups against G = 1.

Inputs are drawn from numpy seeds; JAX weights carry across with
``params_from_numpy``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro.configs import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import GradCompressor as JaxGradCompressor
from repro.distributed import sharding as jsh
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.registry import cache_specs as jax_cache_specs
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import StreamingPipeline, synthetic_documents
from repro_torch.distributed import (
    GradCompressor,
    axes_to_pspec,
    batch_shardings,
    cache_shardings,
    make_rules,
    param_shardings,
)
from repro_torch.distributed.context import (
    activation_sharding,
    batch_shard_count,
    constrain,
    current_mesh,
)
from repro_torch.distributed.sharding import MeshShape, Sharding, _cache_leaf_axes, distribute
from repro_torch.kernels.grouped_matmul.ops import gmm
from repro_torch.kernels.packed_attention.ops import packed_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.launch import train
from repro_torch.models import build_model, init_params, make_batch, params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = ["tp", "fsdp", "serve"]


def abstract_mesh(shape, names):
    """AbstractMesh across jax versions (as tests/test_sharding_and_hlo.py)."""
    try:
        return AbstractMesh(tuple(zip(names, shape, strict=True)))
    except TypeError:
        return AbstractMesh(shape, names)


def both_meshes(key):
    shape, names = MESHES[key]
    return abstract_mesh(shape, names), MeshShape(names, shape)


def jspec(p):
    return tuple(p)


# ---------------------------------------------------------------------------
# (i) rule parity with JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch, mesh_key, layout):
    jmesh, mesh = both_meshes(mesh_key)
    jspecs = jax_build_model(jax_get_config(arch)).param_specs()
    specs = build_model(get_config(arch)).param_specs()
    want = {
        tuple(str(getattr(k, "key", k)) for k in path): jspec(s)
        for path, s in jax.tree_util.tree_flatten_with_path(
            jsh.param_shardings(jspecs, jmesh, jsh.make_rules(jmesh, layout)),
            is_leaf=lambda x: hasattr(x, "spec"))[0]
        for s in [s.spec]}
    got = {path: s.spec for path, s in
           tree_paths(param_shardings(specs, mesh, make_rules(mesh, layout)))}
    assert got == want
    assert make_rules(mesh, layout) == jsh.make_rules(jmesh, layout)


def _rules(mesh_key="16x16"):
    _, mesh = both_meshes(mesh_key)
    return mesh, make_rules(mesh)


def test_heads_shard_when_divisible():
    mesh, rules = _rules()
    assert axes_to_pspec(("embed", "heads", "head_dim"), (8192, 64, 128), rules,
                         mesh) == ("data", "model", None)


def test_kv_heads_replicate_when_indivisible():
    mesh, rules = _rules()
    assert axes_to_pspec(("embed", "kv_heads", "head_dim"), (8192, 8, 128), rules,
                         mesh) == ("data", None, None)


def test_experts_ep_vs_fallback():
    mesh, rules = _rules()
    assert axes_to_pspec(("experts", "embed", "mlp"), (128, 2048, 768), rules,
                         mesh) == ("model", "data", None)
    assert axes_to_pspec(("experts", "embed", "mlp"), (8, 6144, 32768), rules,
                         mesh) == (None, "data", "model")


def test_axis_used_once_per_tensor():
    mesh, rules = _rules()
    assert axes_to_pspec(("vocab", "mlp"), (65536, 4096), rules, mesh) == ("model", None)


def test_kv_seq_composes_remaining_axes():
    mesh, rules = _rules()
    axes = ("layers", "batch", "kv_seq", "kv_heads", None)
    assert axes_to_pspec(axes, (8, 128, 32768, 8, 128), rules, mesh) == (
        None, "data", "model", None, None)
    assert axes_to_pspec(axes, (4, 1, 524288, 8, 128), rules, mesh) == (
        None, None, ("data", "model"), None, None)


def test_multipod_embed_takes_pod_and_data():
    mesh, rules = _rules("2x16x16")
    assert axes_to_pspec(("embed", "mlp"), (8192, 29568), rules, mesh) == (
        ("pod", "data"), "model")


def test_indivisible_dim_skips_axis_entirely():
    mesh, rules = _rules()
    assert axes_to_pspec(("embed", "heads", "head_dim"), (896, 14, 64), rules,
                         mesh) == ("data", None, None)


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_batch_shardings_match_jax(mesh_key, decode):
    jmesh, mesh = both_meshes(mesh_key)
    shapes = ({"tokens": (128, 1)} if decode else
              {"tokens": (256, 4096), "labels": (256, 4096), "segment_ids": (256, 4096),
               "positions": (256, 4096), "vision_embeds": (256, 256, 896),
               "enc_embeds": (1, 512, 1024), "other": (16, 3)})
    for layout in LAYOUTS:
        want = jsh.batch_shardings(
            {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}, jmesh,
            jsh.make_rules(jmesh, layout), decode=decode)
        got = batch_shardings({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                              mesh, make_rules(mesh, layout), decode=decode)
        assert {k: s.spec for k, s in got.items()} == {k: jspec(s.spec)
                                                        for k, s in want.items()}


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_leaf_axes_match_jax(shape_name):
    """``_cache_leaf_axes`` on the paths and shapes of the JAX package's
    caches (every family), and the specs the rules resolve from them."""
    jmesh, mesh = both_meshes("16x16")
    jrules, rules = jsh.make_rules(jmesh), make_rules(mesh)
    seen = set()
    for arch in ARCH_NAMES:
        cache = jax_cache_specs(jax_get_config(arch), JAX_SHAPES[shape_name])
        for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            names = tuple(getattr(k, "key", getattr(k, "name", str(k))) for k in path)
            axes = _cache_leaf_axes(names, leaf.shape)
            assert axes == jsh._cache_leaf_axes(names, leaf.shape)
            assert axes_to_pspec(axes, leaf.shape, rules, mesh) == jspec(
                jsh.axes_to_pspec(axes, leaf.shape, jrules, jmesh))
            seen.add(names[-1])
    assert {"k", "v", "len"} <= seen


def test_cache_shardings_lay_paged_pools_out_by_page():
    mesh, rules = _rules()
    cache = {"k": torch.empty((4, 4096, 16, 8, 128), device="meta"),
             "v": torch.empty((4, 4096, 16, 8, 128), device="meta"),
             "alloc": object(), "seqs": [0, 1],
             "len": torch.empty((128,), dtype=torch.int32, device="meta"),
             "state": [{"ssm": torch.empty((128, 256, 16), device="meta")}],
             "ck": torch.empty((4, 4096, 16, 8, 128), device="meta"),
             "cross_table": torch.empty((128, 32), dtype=torch.int32, device="meta")}
    out = cache_shardings(cache, mesh, rules)
    assert out["k"].spec == (None, ("data", "model"), None, None, None)
    assert out["ck"].spec == out["k"].spec
    assert out["cross_table"].spec == (None, None)
    assert out["len"].spec == ("data",)
    assert out["alloc"] is None and out["seqs"] == [None, None]
    # a recurrent layer's own state, as prefill leaves it: batch first
    assert out["state"][0]["ssm"].spec == ("data", "model", None)


def test_spec_nesting_against_mesh_order_raises():
    _, mesh = both_meshes("2x16x16")
    assert Sharding(mesh, (("pod", "data"), "model")).placements == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        Sharding(mesh, (("data", "pod"), None)).placements


def test_constrain_is_a_no_op_without_a_context():
    x = torch.randn(2, 3, 4)
    assert current_mesh() is None and batch_shard_count(8) == 1
    assert constrain(x, ("batch", "seq", None)) is x
    _, mesh = both_meshes("16x16")
    with activation_sharding(mesh):
        assert current_mesh() is mesh and batch_shard_count(256) == 16
        assert batch_shard_count(8) == 1
        assert constrain(x, ("batch", "seq", None)) is x  # a plain tensor
        with pytest.raises(ValueError, match="rank"):
            constrain(x, ("batch", None))
    assert current_mesh() is None


# ---------------------------------------------------------------------------
# (ii) the compressor against JAX
# ---------------------------------------------------------------------------


def _grad_tree(rng):
    return {"a": rng.normal(size=(64, 48)).astype(np.float32),
            "b": {"c": (rng.normal(size=(300,)) * 1e-3).astype(np.float32),
                  "d": rng.standard_t(3, size=(7, 5, 9)).astype(np.float32)}}


def test_compressor_matches_jax_bit_for_bit_over_five_calls():
    rng = np.random.default_rng(0)
    jc, tc = JaxGradCompressor(stochastic=False), GradCompressor(stochastic=False)
    jef = tef = None
    for _ in range(5):
        g = _grad_tree(rng)
        jdeq, jef = jc.apply(jax.tree.map(jnp.asarray, g), jef)
        tdeq, tef = tc.apply(params_from_numpy(g), tef)
        for a, b in zip(tree_leaves(tdeq) + tree_leaves(tef),
                        jax.tree.leaves(jdeq) + jax.tree.leaves(jef), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressor_stochastic_draws_the_same_noise_every_call():
    """The reference re-derives its noise from ``seed`` on every call."""
    g = params_from_numpy(_grad_tree(np.random.default_rng(1)))
    comp = GradCompressor(stochastic=True, seed=3)
    d1, e1 = comp.apply(g, None)
    d2, e2 = comp.apply(g, None)
    for a, b in zip(tree_leaves(d1) + tree_leaves(e1), tree_leaves(d2) + tree_leaves(e2)):
        assert torch.equal(a, b)
    d3, _ = GradCompressor(stochastic=True, seed=4).apply(g, None)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(d1), tree_leaves(d3)))


def test_compressor_bounded_quant_error():
    comp = GradCompressor(stochastic=False)
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))}
    deq, err = comp.apply(g, None)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((g["w"] - deq["w"]).abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose(err["w"].numpy(), (g["w"] - deq["w"]).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_compressor_error_feedback_is_unbiased_over_time():
    comp = GradCompressor(stochastic=False)
    g_true = torch.from_numpy(
        np.random.default_rng(1).normal(size=(32, 32)).astype(np.float32)) * 1e-3
    ef, total = None, torch.zeros_like(g_true)
    for _ in range(50):
        deq, ef = comp.apply({"w": g_true}, ef)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), (50 * g_true).numpy(), rtol=0.05, atol=1e-4)


def _batches(vocab, seq_len, batch, n, seed=0):
    pipe = StreamingPipeline(
        synthetic_documents(vocab, mean_len=seq_len // 3, max_len=4 * seq_len, seed=seed),
        seq_len=seq_len, batch_size=batch, prefetch=0)
    out = []
    for pb in pipe:
        out.append({k: getattr(pb, k) for k in ("tokens", "labels", "segment_ids",
                                                 "positions")})
        if len(out) == n:
            return out
    raise AssertionError("the stream ended early")


@pytest.fixture(scope="module")
def olmo():
    jm = jax_build_model(jax_get_config("olmo-1b").smoke())
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    cfg = get_config("olmo-1b").smoke()
    return cfg, jm, jp, build_model(cfg)


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def test_training_with_compression_converges(olmo):
    cfg, _, jp, tm = olmo
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    step = make_train_step(tm, OptimizerConfig(learning_rate=3e-3, warmup_steps=2),
                           compressor=GradCompressor(stochastic=False))
    state = init_opt_state(params)
    fixed = to_torch(_batches(cfg.vocab_size, 64, 2, 1)[0])
    losses = []
    for _ in range(10):
        params, state, m = step(params, state, fixed)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert set(state) == {"m", "v", "step", "ef"}


# ---------------------------------------------------------------------------
# (iii) the train step with the compressor against JAX
# ---------------------------------------------------------------------------

# A gradient that differs from JAX's by float noise can straddle a rounding
# boundary (x.5) of the quantizer and land one step (the leaf's scale) away.
# That noise is ~1e-3 of a step at the 99th percentile here, so about 1e-3
# of the elements may flip in a step; over 3 steps they read 1.2e-4 to
# 7.3e-4 of a leaf.  An element off by more than EF_TOL of a step (the error
# feedback) or by more than 1e-4 of the leaf's largest (moments, params)
# counts as flipped; at most FLIP_FRACTION of a leaf's elements may be.
FLIP_FRACTION = 1e-3
EF_TOL = 0.1
GRAD_REL = 1e-4


def test_compressor_on_jax_step_one_gradients_bit_for_bit(olmo):
    cfg, jm, jp, _ = olmo
    batch = _batches(cfg.vocab_size, 64, 2, 1, seed=1)[0]
    jgrads = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    jdeq, jef = JaxGradCompressor(stochastic=False).apply(jgrads, None)
    tdeq, tef = GradCompressor(stochastic=False).apply(
        params_from_numpy(jax.tree.map(np.asarray, jgrads)), None)
    for a, b in zip(tree_leaves(tdeq) + tree_leaves(tef),
                    jax.tree.leaves(jdeq) + jax.tree.leaves(jef), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_step_with_compressor_matches_jax(olmo):
    cfg, jm, jp, tm = olmo
    batches = _batches(cfg.vocab_size, 64, 2, 3, seed=1)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptimizerConfig(), compute_dtype=jnp.float32,
                                        compressor=JaxGradCompressor(stochastic=False)))
    tstep = make_train_step(tm, OptimizerConfig(), compute_dtype=torch.float32,
                            compressor=GradCompressor(stochastic=False))
    p, o = jp, jax_init_opt_state(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    to = init_opt_state(tp)
    for b in batches:
        p, o, jmet = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = tstep(tp, to, to_torch(b))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
    # the error feedback, the moments and the params: equal but where a
    # rounding flipped (|ef| <= scale / 2, so 2 max |ef| ~ the scale)
    for name, want, got in (("ef", o["ef"], to["ef"]), ("m", o["m"], to["m"]),
                            ("v", o["v"], to["v"]), ("params", p, tp)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
            a, b = a.numpy(), np.asarray(b)
            tol = (EF_TOL * 2 * np.abs(b).max() if name == "ef"
                   else GRAD_REL * np.abs(b).max())
            flipped = np.abs(a - b) > tol
            assert flipped.mean() <= FLIP_FRACTION, (name, flipped.mean())


# ---------------------------------------------------------------------------
# (v) the fake backend: placements on the production meshes, the kernel
# wrappers' DTensor rule
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_param_shardings_on_fake_mesh_give_jax_local_shapes(fake_group, multi_pod):
    from repro_torch.launch.mesh import make_production_mesh

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    jmesh, _ = both_meshes("2x16x16" if multi_pod else "16x16")
    sizes = dict(zip(*reversed(MESHES["2x16x16" if multi_pod else "16x16"])))
    for arch in ("olmo-1b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"):
        cfg = get_config(arch).smoke()
        specs = build_model(cfg).param_specs()
        jshard = jsh.param_shardings(jax_build_model(jax_get_config(arch).smoke()).param_specs(),
                                     jmesh, jsh.make_rules(jmesh))
        jleaves = jax.tree.leaves(jshard, is_leaf=lambda x: hasattr(x, "spec"))
        shards = tree_leaves(param_shardings(specs, mesh))
        for spec, sh, js in zip(tree_leaves(specs), shards, jleaves, strict=True):
            want = list(spec.shape)
            for i, entry in enumerate(jspec(js.spec)):
                for a in (() if entry is None else entry if isinstance(entry, tuple)
                          else (entry,)):
                    want[i] //= sizes[a]
            t = distribute(torch.zeros(spec.shape), sh)
            assert isinstance(t, DTensor) and tuple(t.to_local().shape) == tuple(want)


def test_elastic_restore_places_each_leaf_on_the_mesh(fake_group, tmp_path):
    """A checkpoint written from plain tensors restores onto a (2, 2) mesh:
    each leaf a DTensor laid out by ``param_shardings``, this rank's shard
    of the saved values; without ``shardings`` a DTensor target keeps its
    own layout."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import init_params

    cfg = get_config("olmo-1b").smoke()
    specs = build_model(cfg).param_specs()
    params = init_params(specs, torch.Generator().manual_seed(0), torch.float32,
                         torch.device("cpu"))
    CheckpointManager(str(tmp_path)).save(3, params)
    mesh = _fake_mesh(fake_group)
    shard = param_shardings(specs, mesh)
    got = CheckpointManager(str(tmp_path)).restore(3, params, shard)
    for t, full, sh in zip(tree_leaves(got), tree_leaves(params), tree_leaves(shard)):
        assert isinstance(t, DTensor) and tuple(t.placements) == sh.placements
        assert torch.equal(t.to_local(), _rank0_slice(full, sh.placements, mesh))
    again = CheckpointManager(str(tmp_path)).restore(3, got)
    for a, b in zip(tree_leaves(again), tree_leaves(got)):
        assert tuple(a.placements) == tuple(b.placements)
        assert torch.equal(a.to_local(), b.to_local())
    assert any(any(isinstance(p, Shard) for p in t.placements) for t in tree_leaves(got))


def test_make_local_mesh_starts_a_one_rank_group():
    from repro_torch.launch.mesh import make_local_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        # a size-1 mesh dim holds the whole dim: Replicate, whatever the spec
        sh = param_shardings(build_model(get_config("olmo-1b").smoke()).param_specs(),
                             mesh)["embed"]
        assert sh.spec == ("model", "data")
        assert sh.placements == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()


def test_kv_heads_repeated_for_the_kernels_where_they_cannot_shard(fake_group):
    """GQA with fewer KV heads than shards: the kernel path gets K/V
    repeated to q's heads and laid out as q's (JAX's flash-path layout);
    where the KV heads shard as q's, K/V pass unchanged."""
    from repro_torch.models.layers import _kv_heads_as_q, repeat_kv

    mesh = _fake_mesh(fake_group)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k1, k2 = torch.randn(2, 8, 1, 16, generator=g), torch.randn(2, 8, 2, 16, generator=g)
    heads = (Shard(0), Shard(2))
    dq = _local_dt(q, mesh, heads)
    with activation_sharding(mesh):
        out = _kv_heads_as_q(dq, _local_dt(k1, mesh, (Shard(0), Replicate())))
        same = _local_dt(k2, mesh, heads)
        assert _kv_heads_as_q(dq, same) is same
    assert tuple(out.placements) == heads
    assert torch.equal(out.to_local(), _rank0_slice(repeat_kv(k1, 4), heads, mesh))


def test_mamba_block_trains_on_dtensors():
    """A Mamba block's forward and backward on DTensors of a one-rank mesh
    give the plain tensors' output and gradients (the scan's time-major
    gradients made contiguous for DTensor's reshapes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, ssm

    cfg = get_config("jamba-v0.1-52b").smoke()
    specs = build_model(cfg).param_specs()["blocks"]["0"]["mixer"]
    p = {k: v[0] for k, v in init_params(specs, torch.Generator().manual_seed(0),
                                         torch.float32, torch.device("cpu")).items()}
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    w = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_(True) for t in p.values()]
    out, _ = ssm.mamba_forward(dict(zip(p, leaves)), cfg, x)
    want = torch.autograd.grad((out * w).sum(), leaves)
    try:
        mesh = make_local_mesh("cpu")
        dleaves = [DTensor.from_local(t.clone(), mesh, [Replicate(), Replicate()])
                   .requires_grad_(True) for t in p.values()]
        with implicit_replication():
            dout, _ = ssm.mamba_forward(dict(zip(p, dleaves)), cfg,
                                        DTensor.from_local(x, mesh, [Replicate()] * 2))
            got = torch.autograd.grad((dout * w).sum(), dleaves)
        assert torch.allclose(dout.to_local(), out, rtol=1e-6, atol=1e-6)
        for a, b in zip(got, want):
            assert torch.allclose(a.to_local(), b, rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_launch_train_production_mesh_needs_its_ranks(tmp_path):
    args = train.parse_args(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                             "--mesh", "single-pod", "--steps", "1",
                             "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="production mesh needs"):
        train.run(args)


def _local_dt(full, mesh, placements):
    """Rank 0's shard of ``full`` as a DTensor (no collective)."""
    local = full
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.size(m), dim=pl.dim)[0]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _rank0_slice(full, placements, mesh):
    return _local_dt(full, mesh, placements).to_local()


def _fake_mesh(fake_group):
    from torch.distributed.device_mesh import init_device_mesh

    fake_group(4)
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def test_packed_attention_dtensor_rule(fake_group):
    mesh = _fake_mesh(fake_group)
    g = torch.Generator().manual_seed(0)
    B, S, H, KVH, D = 4, 32, 4, 2, 16
    q = torch.randn(B, S, H, D, generator=g)
    k, v = (torch.randn(B, S, KVH, D, generator=g) for _ in range(2))
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[:, S // 2:] = 2
    want = packed_attention(q, k, v, seg, seg)
    qkv_pl, seg_pl = (Shard(0), Shard(2)), (Shard(0), Replicate())
    out = packed_attention(*(_local_dt(t, mesh, qkv_pl) for t in (q, k, v)),
                           *(_local_dt(s, mesh, seg_pl) for s in (seg, seg)))
    assert isinstance(out, DTensor) and tuple(out.placements) == qkv_pl
    assert torch.equal(out.to_local(), _rank0_slice(want, qkv_pl, mesh))
    # forbidden: the sequence sharded, a partial sum, heads apart, a plain input
    bad = [
        ((Shard(0), Shard(1)), qkv_pl, seg_pl, "only its dims"),
        ((Shard(0), Partial()), qkv_pl, seg_pl, "only its dims"),
        (qkv_pl, (Shard(0), Replicate()), seg_pl, "another input"),
        (qkv_pl, qkv_pl, (Shard(0), Shard(1)), "only its dims"),
    ]
    for q_pl, kv_pl, s_pl, msg in bad:
        with pytest.raises(ValueError, match=msg) as err:
            packed_attention(_local_dt(q, mesh, q_pl), _local_dt(k, mesh, kv_pl),
                             _local_dt(v, mesh, kv_pl), _local_dt(seg, mesh, s_pl),
                             _local_dt(seg, mesh, s_pl))
        assert "packed_attention" in str(err.value)
    with pytest.raises(ValueError, match="plain tensor"):
        packed_attention(*(_local_dt(t, mesh, qkv_pl) for t in (q, k, v)), seg, seg)


def test_paged_attention_dtensor_rule(fake_group):
    mesh = _fake_mesh(fake_group)
    g = torch.Generator().manual_seed(1)
    B, H, KVH, D, P, ps = 4, 4, 2, 16, 12, 4
    q = torch.randn(B, H, D, generator=g)
    kp, vp = (torch.randn(P, ps, KVH, D, generator=g) for _ in range(2))
    table = torch.arange(B * 3, dtype=torch.int32).view(B, 3)
    lens = torch.tensor([12, 5, 9, 1], dtype=torch.int32)
    want = paged_attention(q, kp, vp, table, lens)
    q_pl, pool_pl = (Shard(0), Shard(1)), (Replicate(), Shard(2))
    b_pl = (Shard(0), Replicate())
    out = paged_attention(_local_dt(q, mesh, q_pl), _local_dt(kp, mesh, pool_pl),
                          _local_dt(vp, mesh, pool_pl), _local_dt(table, mesh, b_pl),
                          _local_dt(lens, mesh, b_pl))
    assert tuple(out.placements) == q_pl
    assert torch.equal(out.to_local(), _rank0_slice(want, q_pl, mesh))
    with pytest.raises(ValueError, match="paged_attention: k_pool"):
        paged_attention(_local_dt(q, mesh, q_pl), _local_dt(kp, mesh, (Shard(0), Shard(2))),
                        _local_dt(vp, mesh, pool_pl), _local_dt(table, mesh, b_pl),
                        _local_dt(lens, mesh, b_pl))


def test_gmm_dtensor_rule(fake_group):
    mesh = _fake_mesh(fake_group)
    g = torch.Generator().manual_seed(2)
    E, C, d, f = 4, 8, 16, 24
    x = torch.randn(E, C, d, generator=g)
    w = torch.randn(E, d, f, generator=g)
    gs = torch.tensor([8, 3, 0, 5], dtype=torch.int32)
    want = gmm(x, w, gs)
    out = gmm(_local_dt(x, mesh, (Replicate(), Shard(0))),
              _local_dt(w, mesh, (Shard(2), Shard(0))),
              _local_dt(gs, mesh, (Replicate(), Shard(0))))
    assert tuple(out.placements) == (Shard(2), Shard(0))
    assert torch.equal(out.to_local(), _rank0_slice(want, (Shard(2), Shard(0)), mesh))
    with pytest.raises(ValueError, match="gmm: w"):  # the contraction dim sharded
        gmm(_local_dt(x, mesh, (Replicate(), Shard(0))),
            _local_dt(w, mesh, (Shard(1), Shard(0))),
            _local_dt(gs, mesh, (Replicate(), Shard(0))))


class _StridedWatch(TorchDispatchMode):
    """Records every DTensor op given a ``_StridedShard`` placement (a
    sharded dim merged with another, which torch 2.11 refuses).  It
    declines the DTensor-level call, so DTensor dispatches as it would
    without it."""

    def __init__(self):
        super().__init__()
        self.strided = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            for a in pytree_leaves((args, kwargs or {})):
                if isinstance(a, DTensor) and any(
                        isinstance(pl, _StridedShard) for pl in a.placements):
                    self.strided.append((str(func), tuple(a.shape), a.placements))
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_train_step_on_a_2x2_mesh_lays_nothing_out_strided(fake_group, arch):
    """One train step at smoke size on a (2, 2) mesh (the fake backend):
    no op sees a ``_StridedShard`` placement.  This box's torch lays such a
    merge out strided and goes on; the card's torch 2.11 refuses it, so this
    is where that refusal shows here."""
    mesh = _fake_mesh(fake_group)
    rules = make_rules(mesh)
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    specs = model.param_specs()
    params = init_params(specs, torch.Generator().manual_seed(0), torch.float32,
                         torch.device("cpu"))
    batch = make_batch(cfg, "train", 4, 32)
    p_shard = param_shardings(specs, mesh, rules)
    b_shard = batch_shardings(batch, mesh, rules)
    dparams = tree_map(distribute, params, p_shard)
    dbatch = {k: distribute(v, b_shard[k]) for k, v in batch.items()}
    step = make_train_step(model, OptimizerConfig(), grad_shardings=p_shard,
                           compute_dtype=torch.float32)
    watch = _StridedWatch()
    with activation_sharding(mesh, rules), implicit_replication(), watch:
        _, _, metrics = step(dparams, init_opt_state(dparams), dbatch)
    assert watch.strided == []
    assert metrics["loss"].shape == ()


# ---------------------------------------------------------------------------
# (iv) four gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent('''
    import dataclasses, json, os, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import GradCompressor, batch_shardings, make_rules, param_shardings
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import build_model, init_params
    from repro_torch.models.moe import moe_layer
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def rel_leaves(a, b):
        return max(float((full(x) - y).abs().max() / y.abs().max().clamp(min=1e-30))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def batch_of(cfg, B, S, seed):
        g = torch.Generator().manual_seed(seed)
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
        seg = torch.ones(B, S, dtype=torch.int32)
        seg[:, S // 3:] = 2
        pos = torch.cat([torch.arange(S // 3), torch.arange(S - S // 3)]).int().expand(B, S)
        return {"tokens": tok, "labels": tok.roll(-1, 1), "segment_ids": seg,
                "positions": pos.contiguous()}

    def main(rank):
        dist.init_process_group("gloo", init_method=sys.argv[1], rank=rank, world_size=4)
        torch.set_num_threads(1)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        out = {}
        # one olmo-1b smoke train step: DTensor params, constrain active
        cfg = get_config("olmo-1b").smoke()
        model = build_model(cfg)
        specs = model.param_specs()
        params = init_params(specs, torch.Generator().manual_seed(0), torch.float32,
                             torch.device("cpu"))
        batch = batch_of(cfg, 4, 64, 1)
        p_shard = param_shardings(specs, mesh, rules)
        kw = dict(compute_dtype=torch.float32, compressor=GradCompressor(stochastic=False))
        p1, o1, m1 = make_train_step(model, OptimizerConfig(), **kw)(
            params, init_opt_state(params), batch)
        dparams = tree_map(distribute, params, p_shard)
        b_shard = batch_shardings(batch, mesh, rules)
        dbatch = {k: distribute(v, b_shard[k]) for k, v in batch.items()}
        step = make_train_step(model, OptimizerConfig(), grad_shardings=p_shard, **kw)
        with activation_sharding(mesh, rules), implicit_replication():
            dp1, do1, dm1 = step(dparams, init_opt_state(dparams), dbatch)
        out["placed"] = [str(t.placements) for t in tree_leaves(dparams)]
        out["loss"] = [float(full(dm1["loss"])), float(m1["loss"])]
        out["params_rel"] = rel_leaves(dp1, p1)
        out["ef_flipped"] = max(
            float(((full(x) - y).abs() > 0.2 * y.abs().max()).float().mean())
            for x, y in zip(tree_leaves(do1["ef"]), tree_leaves(o1["ef"])))
        # the compressor on sharded gradients against the same gradients whole
        g = {"a": torch.randn(8, 12, generator=torch.Generator().manual_seed(5))}
        dg = {"a": distribute(g["a"], p_shard["embed"])}
        for stochastic in (False, True):
            c = GradCompressor(stochastic=stochastic, seed=7)
            want, dwant = c.apply(g, None), c.apply(dg, None)
            out[f"compress_equal_{stochastic}"] = all(
                torch.equal(full(x), y) for x, y in zip(
                    tree_leaves(dwant[0]) + tree_leaves(dwant[1]),
                    tree_leaves(want[0]) + tree_leaves(want[1])))
        # the MoE layer: G = 2 groups (DTensors on the mesh) against G = 1,
        # at a capacity no bin overflows
        cfg = get_config("qwen3-moe-30b-a3b").smoke()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        model = build_model(cfg)
        specs = model.param_specs()["blocks"]["0"]["ffn"]
        specs = {k: dataclasses.replace(s, shape=s.shape[1:], axes=s.axes[1:])
                 for k, s in specs.items()}
        p = init_params(specs, torch.Generator().manual_seed(2), torch.float32,
                        torch.device("cpu"))
        x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
        want, waux = moe_layer(p, cfg, x)
        dp = tree_map(distribute, p, param_shardings(specs, mesh, rules))
        dx = distribute(x, batch_shardings({"x": torch.empty(4, 16, cfg.d_model)}, mesh,
                                           rules)["x"])
        dx.requires_grad_(True)
        with activation_sharding(mesh, rules), implicit_replication():
            got, aux = moe_layer(dp, cfg, dx)
            got.sum().backward()
        out["moe_groups"] = [int(got.placements[0].dim) if got.placements[0].is_shard() else -1]
        out["moe_out_rel"] = float((full(got) - want).abs().max() / want.abs().max())
        out["moe_drop"] = [float(full(aux["moe_drop_fraction"])), float(waux["moe_drop_fraction"])]
        out["moe_z"] = [float(full(aux["moe_z_loss"])), float(waux["moe_z_loss"])]
        out["moe_grad_finite"] = bool(torch.isfinite(full(dx.grad)).all())
        if rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.spawn(main, nprocs=4)
''')


@pytest.mark.timeout(600)
def test_four_gloo_ranks_reproduce_the_single_process_port(tmp_path):
    import socket

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), f"tcp://localhost:{port}"],
                         capture_output=True, text=True, timeout=540, env=env,
                         cwd=tmp_path)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    assert res.returncode == 0 and lines, res.stderr[-3000:]
    out = json.loads(lines[0][len("RESULT "):])
    # the tables are sharded over both mesh dims
    assert "(Shard(dim=1), Shard(dim=0))" in out["placed"]
    dl, l1 = out["loss"]
    assert abs(dl - l1) <= 1e-5 * abs(l1)
    assert out["params_rel"] <= 1e-5
    # the error feedback: equal but where a rounding flipped (EF_TOL)
    assert out["ef_flipped"] <= FLIP_FRACTION
    assert out["compress_equal_False"] and out["compress_equal_True"]
    assert out["moe_groups"] == [0]  # the groups lie over the data axis
    assert out["moe_out_rel"] <= 1e-5
    assert out["moe_drop"] == [0.0, 0.0]
    assert abs(out["moe_z"][0] - out["moe_z"][1]) <= 1e-5 * abs(out["moe_z"][1])
    assert out["moe_grad_finite"]


# ---------------------------------------------------------------------------
# the recurrent scans on four gloo ranks, each on its own rows and channels
# ---------------------------------------------------------------------------

_RECURRENT_WORKER = textwrap.dedent('''
    import dataclasses, sys
    import numpy as np
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import batch_shardings, cache_shardings, make_rules
    from repro_torch.distributed import param_shardings
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving.kv_cache import PagedCacheLayout

    def placed(node, shard):
        if isinstance(node, dict):
            return {k: placed(v, shard[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [placed(v, s) for v, s in zip(node, shard)]
        return distribute(node, shard) if isinstance(node, torch.Tensor) else node

    def config(arch):
        cfg = get_config(arch).smoke()
        if cfg.moe is not None:  # every bin holds its tokens, with one group or two
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        return cfg

    def main(rank):
        dist.init_process_group("gloo", init_method=sys.argv[1], rank=rank, world_size=4)
        torch.set_num_threads(1)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        res = {}
        a = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[2]).items()}
        for arch in ("jamba-v0.1-52b", "xlstm-125m"):
            cfg = config(arch)
            model = build_model(cfg)
            specs = model.param_specs()
            params = init_params(specs, torch.Generator().manual_seed(0), torch.float32, "cpu")
            layout = PagedCacheLayout(num_pages=16, page_size=4, n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.head_dim_, max_pages_per_seq=4)
            cache = model.init_paged_cache(layout, torch.float32)
            cache = placed(cache, cache_shardings(cache, mesh, rules))
            b_shard = batch_shardings(a, mesh, rules)
            batch = {k: distribute(v, b_shard[k]) for k, v in a.items()}
            dparams = tree_map(distribute, params, param_shardings(specs, mesh, rules))
            with activation_sharding(mesh, rules), implicit_replication():
                logits, cache = model.prefill(dparams, batch, cache)
            res[arch + "/logits"] = logits.full_tensor().numpy()
            for i, state in enumerate(cache["state"]):
                for k, v in state.items():
                    res[f"{arch}/state/{i}/{k}"] = v.full_tensor().numpy()
        if rank == 0:
            np.savez(sys.argv[3], **res)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.spawn(main, nprocs=4)
''')


RECURRENT_LOGIT_ATOL = {"jamba-v0.1-52b": 4e-4, "xlstm-125m": 6e-5}
RECURRENT_STATE_REL = 5e-4


@pytest.mark.timeout(300)
def test_recurrent_prefill_on_four_ranks_matches_one_process(tmp_path):
    """jamba-v0.1-52b and xlstm-125m at smoke size, a prefill of 4 rows of
    16 tokens on a (2, 2) mesh of four gloo ranks: each scan runs on the
    rank's own rows and channels (or heads), its state made there.  The
    gathered logits and every recurrent state equal one process's: fp32,
    the mesh summing in another order, which these random-weight models
    amplify with depth as they amplify a rounding of their weights (the
    noise floor of ``test_torch_archs.py``'s ``FLOOR``).  So the logits are
    held at FLOOR's logit limits, and each state within
    ``RECURRENT_STATE_REL`` of its largest magnitude (read: 2.4e-4 at most,
    on the last sLSTM layer's c; jamba's states 2.5e-5); a layout fault
    moves them by their own size."""
    import dataclasses
    import socket

    from repro_torch.serving.kv_cache import PagedCacheLayout

    B, S = 4, 16
    rng = np.random.default_rng(6)
    a = {"tokens": rng.integers(1, 256, size=(B, S)).astype(np.int32),
         "segment_ids": np.ones((B, S), np.int32),
         "positions": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()}
    inputs = tmp_path / "in.npz"
    np.savez(inputs, **a)
    script = tmp_path / "worker.py"
    script.write_text(_RECURRENT_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), f"tcp://localhost:{port}",
                          str(inputs), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=270, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    for arch in ("jamba-v0.1-52b", "xlstm-125m"):
        cfg = get_config(arch).smoke()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        model = build_model(cfg)
        params = init_params(model.param_specs(), torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
        layout = PagedCacheLayout(num_pages=16, page_size=4, n_kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.head_dim_, max_pages_per_seq=4)
        logits, cache = model.prefill(params, {k: torch.from_numpy(v) for k, v in a.items()},
                                      model.init_paged_cache(layout, torch.float32))
        want = {"logits": logits.numpy()}
        for i, state in enumerate(cache["state"]):
            for k, v in state.items():
                want[f"state/{i}/{k}"] = v.numpy()
        assert len(want) > 1
        for key, w in want.items():
            g = got[f"{arch}/{key}"]
            assert g.shape == w.shape, key
            tol = RECURRENT_LOGIT_ATOL[arch] if key == "logits" else (
                RECURRENT_STATE_REL * np.abs(w).max())
            assert np.abs(g - w).max() <= tol, (arch, key)
