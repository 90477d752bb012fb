"""The port's dry-run and cost analysis (``repro_torch.launch.dryrun``,
``analysis``, ``trace_analysis``, ``profile_cell``) on the CPU against the
JAX package's.

  - the JAX package's dry-run test, mirrored: olmo-1b at ``decode_32k`` on
    both production meshes (a ``fake`` process group of 256 and 512 ranks);
    a train cell counted through the kernels' operators, never their plain
    versions;
  - the JAX package's pure-rule tests of ``hlo_analysis``
    (``tests/test_sharding_and_hlo.py``), each held to JAX's rule on the
    same products, collectives and pod size: dot FLOPs, a loop counted per
    trip, wire bytes per collective kind, the cross-pod class, the ranking;
    and one device's count on the 16x16 mesh against one rank's;
  - the FLOP oracle: a smoke-size olmo-1b train step and decode step,
    counted on meta stand-ins, against ``analyze_hlo_text`` of the JAX
    package's same step compiled on one CPU device;
  - ``decode_attention_distributed`` on a (2, 2) mesh of four gloo ranks
    (a subprocess) against JAX's single-device ``decode_attention`` on the
    same cache gathered dense, and the page-local K/V write;
  - ``torch.library.opcheck`` of each kernel operator's fake against its
    CPU (plain) implementation;
  - a train step's peak: in AdamW's update of the last leaf it walks, in
    sorted path order on stand-ins as on the card's parameters, equal to
    what its shapes give and to the count over real CPU tensors;
  - on the card only (``cuda``): a smoke step's count on meta stand-ins
    equal to ``FlopCounterMode``'s count of the same step run on the card,
    and a two-layer olmo-1b step's peak within 1.5% of the card's.

JAX and the JAX package are imported inside the tests that use them, so
that the card, which has neither, can run the ``cuda`` test.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.packed_attention import ops as packed_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import collective_wire_bytes
from repro_torch.launch.trace_analysis import analyze_step, top_collectives
from repro_torch.models import abstract_params, build_model, cache_specs, input_specs
from repro_torch.training import OptimizerConfig, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def fake_group():
    yield dryrun.fake_process_group
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry-run itself
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_dryrun_single_cell(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "olmo-1b", "--shape", "decode_32k",
         "--multi-pod", "both", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=270,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[OK] olmo-1b x decode_32k") == 2
    records = json.loads(out.read_text())
    assert len(records) == 2
    for rec in records:
        assert "error" not in rec
        assert rec["chips"] in (256, 512)
        assert rec["memory"]["total_hbm_bytes"] > 0
        assert rec["flops_per_dev"] > 0
        assert rec["collectives"]["total"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
    multi = next(r for r in records if r["mesh"] == "2x16x16")
    assert multi["chips"] == 512
    # one device's shards: the bf16 weights and the paged cache over 256
    single = next(r for r in records if r["mesh"] == "16x16")
    shards = (single["param_bytes_global"] / 2 + single["cache_bytes_global"]) / 256
    assert single["memory"]["argument_size_in_bytes"] == pytest.approx(shards, rel=0.02)


def test_train_cell_counts_the_kernels_not_their_plain_versions(fake_group, monkeypatch):
    """The attention of a train cell on the 16x16 mesh is the packed
    kernels' operators, counted by their formulas; the plain versions (the
    dense (B, H, S, S) scores and the chunked flash path) never run."""
    def refuse(*args, **kwargs):
        raise AssertionError("a dry-run took a kernel's plain version")

    monkeypatch.setattr(packed_ops, "packed_attention_plain", refuse)
    monkeypatch.setattr("repro_torch.models.layers.flash_attention", refuse)
    fake_group(256)
    rec = dryrun.lower_cell("olmo-1b", "train_4k", keep_hlo=True)
    by_op = rec["_cost"].flops_by_op
    cfg = get_config("olmo-1b")
    # per device: 16 rows of 4096 tokens, 1 of 16 heads of 128, 16 layers;
    # remat "nothing" runs each forward twice
    pairs = packed_ops.visible_pairs(16, 4096, 4096, True, 0)
    assert by_op["repro_torch.packed_attention_fwd"] == 2 * 4 * 128 * 1 * pairs * cfg.n_layers
    assert by_op["repro_torch.packed_attention_bwd"] == 10 * 128 * 1 * pairs * cfg.n_layers
    assert rec["memory"]["temp_size_in_bytes"] < 80e9
    assert rec["dominant"] == "collective"


def test_decode_cell_on_one_rank_counts_the_grouped_matmul(fake_group):
    """On a (1, 1) mesh (the card's) the MoE layer takes the grouped-matmul
    kernel, and the paged kernel serves the cache: both counted by their
    operators' formulas."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_group(1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("qwen3-moe-30b-a3b")
    shape = ShapeConfig("decode_small", "decode", 64, 4)
    rec = dryrun.lower_cell("qwen3-moe-30b-a3b", "decode_small", mesh=mesh, shape=shape,
                            keep_hlo=True)
    by_op = rec["_cost"].flops_by_op
    n = cfg.n_layers
    assert by_op["repro_torch.paged_attention"] == 4 * 4 * 64 * cfg.n_heads * cfg.head_dim_ * n
    assert by_op["repro_torch.gmm"] > 0
    assert rec["chips"] == 1 and rec["collectives"]["total"] == 0


def test_profile_cell_prints_the_top_collectives():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile_cell",
         "--arch", "olmo-1b", "--shape", "train_4k", "--top", "5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=270)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "top 5 collective contributors" in proc.stdout
    rows = proc.stdout.split("collective contributors")[1].strip().splitlines()[1:]
    assert len(rows) == 5
    gb = [float(r.split()[0]) for r in rows]
    assert gb == sorted(gb, reverse=True) and gb[0] > 0


# ---------------------------------------------------------------------------
# the pure rules, held to the JAX package's hlo_analysis
# ---------------------------------------------------------------------------


def test_dot_flops_counted():
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo_text

    hlo = jax.jit(lambda a, b: a @ b).lower(
        jnp.zeros((128, 256)), jnp.zeros((256, 64))).compile().as_text()
    _, cost = analyze_step(lambda a, b: a @ b, meta(128, 256), meta(256, 64))
    assert cost.flops == analyze_hlo_text(hlo).flops == 2 * 128 * 256 * 64
    assert cost.dot_bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_loop_counted_per_trip():
    """JAX's test counts a scan's body by its trip count; the dispatch
    stream holds every trip, so a Python loop of the same products counts
    the same."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo_text

    TRIPS = 7

    def f(x):
        out, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=TRIPS)
        return out

    def g(x):
        for _ in range(TRIPS):
            x = x @ x
        return x

    hlo = jax.jit(f).lower(jnp.zeros((64, 64))).compile().as_text()
    _, cost = analyze_step(g, meta(64, 64))
    assert cost.flops == TRIPS * 2 * 64 ** 3
    assert analyze_hlo_text(hlo).flops == pytest.approx(cost.flops, rel=0.05)


def test_collective_wire_bytes_conventions(fake_group):
    from torch.distributed import _functional_collectives as funcol

    from repro.launch.hlo_analysis import analyze_hlo_text

    hlo = """
HloModule test

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[4096]{0} all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %cp = f32[1024]{0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""
    jcost = analyze_hlo_text(hlo)
    fake_group(4)
    group = dist.group.WORLD

    def step(x):
        ar = funcol.all_reduce(x, "sum", group)
        return funcol.all_gather_single(ar, 0, group)

    _, cost = analyze_step(step, meta(1024))
    assert cost.coll["all-reduce"] == jcost.coll["all-reduce"] == 2 * 4096.0
    assert cost.coll["all-gather"] == jcost.coll["all-gather"] == 16384.0
    # no functional collective permutes: the rule itself
    assert collective_wire_bytes("collective-permute", 4096.0, 4096.0) == \
        jcost.coll["collective-permute"]
    assert cost.coll_count == 2 and cost.dcn_bytes == jcost.dcn_bytes == 0.0
    # reduce-scatter: the input's bytes
    _, rs = analyze_step(lambda x: funcol.reduce_scatter_single(x, "sum", 0, group),
                         meta(1024))
    assert rs.coll["reduce-scatter"] == 4096.0


def test_cross_pod_classified_as_dcn(fake_group):
    from torch.distributed import _functional_collectives as funcol

    from repro.launch.hlo_analysis import analyze_hlo_text

    hlo = """
HloModule test

ENTRY %main (p0: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  ROOT %ar = f32[256]{0} all-reduce(%p0), replica_groups={{0,256}}, to_apply=%add
}
"""
    jcost = analyze_hlo_text(hlo, pod_size=256)
    fake_group(512)
    pair = dist.new_group([0, 256])
    within = dist.new_group(list(range(256)))
    _, cost = analyze_step(lambda x: funcol.all_reduce(x, "sum", pair), meta(256),
                           pod_size=256)
    assert cost.dcn_bytes == jcost.dcn_bytes == 2 * 1024.0
    assert cost.ici_bytes == jcost.ici_bytes == 0.0
    _, cost = analyze_step(lambda x: funcol.all_reduce(x, "sum", within), meta(256),
                           pod_size=256)
    assert cost.dcn_bytes == 0.0 and cost.ici_bytes == 2 * 1024.0


def test_top_collectives_ranking(fake_group):
    """Ranked by bytes x calls: a small collective called often outranks a
    larger one called once.  With no collective (one device, as the JAX
    test's program) the list is empty, as JAX's."""
    from torch.distributed import _functional_collectives as funcol

    _, cost = analyze_step(lambda x: x @ x @ x @ x, meta(32, 32))
    assert top_collectives(cost, n=5) == []
    fake_group(4)
    group = dist.group.WORLD

    def step(small, large):
        for _ in range(10):
            small = funcol.all_reduce(small, "sum", group)
        return small, funcol.all_gather_single(large, 0, group)

    _, cost = analyze_step(step, meta(256), meta(1024))
    rows = top_collectives(cost, n=5)
    assert [(r[1], r[3]) for r in rows] == [("all-reduce", 10), ("all-gather", 1)]
    assert rows[0][2] == 10 * 2 * 1024.0 and rows[1][2] == 16384.0


def test_one_device_of_the_16x16_mesh_counts_a_sixteenth(fake_group):
    """A data-parallel product on the 16x16 mesh: one device's FLOPs and
    product bytes are one rank's count at the same global shape over 16."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    _, whole = analyze_step(lambda x, w: x @ w, meta(512, 256), meta(256, 128))
    fake_group(256)
    mesh = init_device_mesh("cuda", (16, 16), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(meta(32, 256), mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(meta(256, 128), mesh, [Replicate(), Replicate()],
                           run_check=False)
    _, dev = analyze_step(lambda x, w: x @ w, x, w)
    assert dev.flops == whole.flops / 16
    assert dev.coll_count == 0


# ---------------------------------------------------------------------------
# the FLOP oracle: a smoke step counted on stand-ins against JAX's HLO
# ---------------------------------------------------------------------------
#
# Tolerance, argued before the numbers: the two steps run the same weight
# products at the same shapes, so their FLOPs agree exactly but for the
# attention cores and the cross-entropy's recomputation.  On the CPU the
# JAX step attends through its chunked flash path, which computes every
# (query, key) pair of each chunk (S <= 512 here: one chunk): 2 products of
# 2 B H S^2 D forward, 2 more where the layer's remat "nothing" recomputes
# them, and 4 in their backward, 16 B H S^2 D a layer.  The port's step
# attends through the packed kernels' operators, whose formulas count the
# causal pairs, B S (S + 1) / 2: 4 D H a pair forward, twice under remat,
# and 10 D H backward.  JAX's compiled step computes each cross-entropy
# chunk's logits three times (forward, and the two products of the
# backward); the port's checkpoint recomputes them once more in the
# backward, 2 B S d V more.  With those terms taken out of each side the
# counts must be equal (fp64 sums of integers: rel 1e-12).  The decode step
# has no such term: the paged kernel's formula counts the page table's
# capacity, which here is JAX's dense cache length, so the two are equal.


def _jax_step_flops(arch, B, S, kind):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch.hlo_analysis import analyze_hlo_text
    from repro.models import build_model as jax_build_model
    from repro.models import init_params as jax_init_params
    from repro.models.registry import make_batch as jax_make_batch
    from repro.training import OptimizerConfig as JaxOptimizerConfig
    from repro.training import init_opt_state as jax_init_opt_state
    from repro.training import make_train_step as jax_make_train_step

    jcfg = jax_get_config(arch).smoke()
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    if kind == "train":
        step = jax_make_train_step(jm, JaxOptimizerConfig(), remat_policy="nothing")
        lowered = jax.jit(step).lower(jp, jax_init_opt_state(jp),
                                      jax_make_batch(jcfg, "train", B, S))
    else:
        lowered = jax.jit(jm.decode_step).lower(
            jp, {"tokens": jnp.zeros((B, 1), jnp.int32)},
            jm.init_cache(B, S, dtype=jnp.float32))
    assert len(jax.devices()) == 1
    return analyze_hlo_text(lowered.compile().as_text()).flops


def _port_step_cost(arch, B, S, kind):
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    specs = model.param_specs()
    shape = ShapeConfig("smoke", kind, S, B)
    if kind == "train":
        opt = {"m": abstract_params(specs), "v": abstract_params(specs),
               "step": meta(dtype=torch.int32)}
        step = make_train_step(model, OptimizerConfig(), remat_policy="nothing",
                               compute_dtype=torch.float32)
        return cfg, analyze_step(step, abstract_params(specs), opt,
                                 input_specs(cfg, shape))[1]
    return cfg, analyze_step(model.decode_step, abstract_params(specs),
                             input_specs(cfg, shape),
                             cache_specs(cfg, shape, dtype=torch.float32))[1]


def test_train_step_flops_match_jax():
    B, S = 2, 64
    jax_flops = _jax_step_flops("olmo-1b", B, S, "train")
    cfg, cost = _port_step_cost("olmo-1b", B, S, "train")
    L, H, D, d = cfg.n_layers, cfg.n_heads, cfg.head_dim_, cfg.d_model
    pairs = B * S * (S + 1) // 2
    port_attn = (2 * 4 + 10) * D * H * pairs * L
    jax_attn = 16 * B * H * S * S * D * L
    ce_recompute = 2 * B * S * d * 256  # the padded vocabulary
    assert cost.flops_by_op["repro_torch.packed_attention_fwd"] + \
        cost.flops_by_op["repro_torch.packed_attention_bwd"] == port_attn
    assert cost.flops - port_attn - ce_recompute == pytest.approx(
        jax_flops - jax_attn, rel=1e-12)


def test_decode_step_flops_match_jax():
    B, S = 2, 64
    jax_flops = _jax_step_flops("olmo-1b", B, S, "decode")
    _, cost = _port_step_cost("olmo-1b", B, S, "decode")
    assert cost.flops == pytest.approx(jax_flops, rel=1e-12)
    assert cost.flops_by_op["repro_torch.paged_attention"] > 0


# ---------------------------------------------------------------------------
# decode_attention_distributed on four gloo ranks against JAX
# ---------------------------------------------------------------------------

_DECODE_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import axes_to_pspec, make_rules
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.distributed.sharding import Sharding, distribute
    from repro_torch.models.layers import _page_dims, _write_local, decode_attention_distributed

    def main(rank):
        dist.init_process_group("gloo", init_method=sys.argv[1], rank=rank, world_size=4)
        torch.set_num_threads(1)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        a = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[2]).items()}

        def placed(t, axes):
            return distribute(t, Sharding(mesh, axes_to_pspec(axes, tuple(t.shape), rules, mesh)))

        pool_axes = ("pages", None, "kv_heads", None)
        k, v = placed(a["k_pool"], pool_axes), placed(a["v_pool"], pool_axes)
        q = placed(a["q"], ("batch", "heads", None))
        with activation_sharding(mesh, rules):
            out = decode_attention_distributed(q, k, v, a["table"], a["lens"])
            out_w = decode_attention_distributed(q, k, v, a["table"], a["lens"],
                                                 window=int(a["window"]))
            dims = _page_dims(k)
            _write_local(k, dims, a["page"], a["slot"], placed(a["new_k"], ("batch", "kv_heads", None)))
        res = {"out": out.full_tensor().numpy(), "out_window": out_w.full_tensor().numpy(),
               "k_after": k.full_tensor().numpy(),
               "placements": np.array([str(k.placements)])}
        if rank == 0:
            np.savez(sys.argv[3], **res)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.spawn(main, nprocs=4)
''')


@pytest.mark.timeout(300)
def test_distributed_decode_on_four_ranks_matches_jax(tmp_path):
    """Four gloo ranks on a (2, 2) mesh, the pools' 32 pages sharded four
    ways by page, each sequence's pages scattered over the ranks: the
    distributed decode against JAX's single-device ``decode_attention`` on
    the same cache gathered dense, within 1e-5 of the output's largest
    value (fp32 throughout; the partials combine in another order), with
    no window and with JAX's sliding window of 6 tokens.  Then
    each rank writes a token's K into the pages it holds: the gathered pool
    equals the same writes on one process, bit for bit."""
    import socket

    import jax.numpy as jnp

    from repro.models.layers import decode_attention as jax_decode_attention

    rng = np.random.default_rng(7)
    B, H, KVH, D, ps, n_pages, max_pages = 4, 8, 4, 16, 4, 32, 8
    lens = np.array([5, 23, 30, 17], np.int32)
    perm = rng.permutation(n_pages)
    table = np.full((B, max_pages), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        need = -(-int(n + 1) // ps)  # room for the written token too
        table[b, :need] = perm[used:used + need]
        used += need
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k_pool = rng.normal(size=(n_pages, ps, KVH, D)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, ps, KVH, D)).astype(np.float32)
    new_k = rng.normal(size=(B, KVH, D)).astype(np.float32)
    page = table[np.arange(B), lens // ps].astype(np.int64)
    slot = (lens % ps).astype(np.int64)

    def dense(pool):
        return pool[np.clip(table, 0, None)].reshape(B, max_pages * ps, KVH, D)

    want, want_w = (np.asarray(jax_decode_attention(
        jnp.asarray(q[:, None]), jnp.asarray(dense(k_pool)), jnp.asarray(dense(v_pool)),
        jnp.asarray(lens), window=w))[:, 0] for w in (0, 6))
    k_after = k_pool.copy()
    k_after[page, slot] = new_k
    inputs = tmp_path / "in.npz"
    np.savez(inputs, q=q, k_pool=k_pool, v_pool=v_pool, table=table, lens=lens,
             page=page, slot=slot, new_k=new_k, window=np.int32(6))
    script = tmp_path / "worker.py"
    script.write_text(_DECODE_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), f"tcp://localhost:{port}",
                          str(inputs), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=270, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    assert "Shard(dim=0), Shard(dim=0)" in str(got["placements"][0])
    assert np.abs(got["out"] - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got["out_window"] - want_w).max() <= 1e-5 * np.abs(want_w).max()
    assert np.abs(want_w - want).max() > 1e-2  # the window acts
    np.testing.assert_array_equal(got["k_after"], k_after)


def test_distributed_decode_needs_a_mesh_and_sharded_pages():
    from repro_torch.models.layers import decode_attention_distributed

    q, pool = torch.zeros(2, 4, 16), torch.zeros(8, 4, 2, 16)
    table, lens = torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    assert decode_attention_distributed(q, pool, pool, table, lens) is None


# ---------------------------------------------------------------------------
# the kernels' operators
# ---------------------------------------------------------------------------


def _opcheck(op, args):
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_gmm_operator_fake_matches_its_plain_version():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 8, 16, generator=g), torch.randn(3, 16, 24, generator=g)
    gs = torch.tensor([8, 3, 0], dtype=torch.int32)
    _opcheck(torch.ops.repro_torch.gmm.default, (x, w, gs))
    assert torch.equal(torch.ops.repro_torch.gmm(x, w, gs), gmm_ops.gmm(x, w, gs))


def test_packed_operators_fake_match_their_plain_versions():
    g = torch.Generator().manual_seed(1)
    B, S, H, KVH, D = 2, 32, 4, 2, 16
    q = torch.randn(B, S, H, D, generator=g).bfloat16()
    k = torch.randn(B, S, KVH, D, generator=g).bfloat16()
    v = torch.randn(B, S, KVH, D, generator=g).bfloat16()
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[1, 20:] = 2
    seg[0, 28:] = 0
    for residual in (False, True):
        _opcheck(torch.ops.repro_torch.packed_attention_fwd.default,
                 (q, k, v, seg, seg, True, 0, residual))
    _, _, none = torch.ops.repro_torch.packed_attention_fwd(q, k, v, seg, seg, True, 0, False)
    assert none.numel() == 0  # no residual unless asked for
    out, lse, out_lo = torch.ops.repro_torch.packed_attention_fwd(q, k, v, seg, seg, True, 0,
                                                                  True)
    assert torch.equal(out, packed_ops.packed_attention(q, k, v, seg, seg))
    assert out_lo.shape == out.shape and out_lo.dtype == out.dtype
    assert torch.isinf(lse[0, :, 28:]).all() and torch.isfinite(lse[0, :, :28]).all()
    dout = torch.randn(B, S, H, D, generator=g).bfloat16()
    _opcheck(torch.ops.repro_torch.packed_attention_bwd.default,
             (q, k, v, seg, seg, out, out_lo, dout, lse, True, 0))
    dq, dk, dv = torch.ops.repro_torch.packed_attention_bwd(q, k, v, seg, seg, out, out_lo,
                                                            dout, lse, True, 0)
    # against autograd of the plain version: the same fp32 arithmetic summed
    # in another order, each rounded once to bf16 (2^-8 of a value)
    qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
    packed_ops.packed_attention(*qkv, seg, seg).backward(dout)
    for got, t in zip((dq, dk, dv), qkv):
        torch.testing.assert_close(got.float(), t.grad.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * t.grad.float().abs().max().item())


def test_paged_operator_fake_matches_its_plain_version():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 16, generator=g)
    k_pool, v_pool = torch.randn(6, 4, 2, 16, generator=g), torch.randn(6, 4, 2, 16, generator=g)
    table = torch.tensor([[0, 3, -1], [5, 1, 2]], dtype=torch.int32)
    lens = torch.tensor([6, 11], dtype=torch.int32)
    for window in (0, 5):  # none, and a sliding window inside the table
        args = (q, k_pool, v_pool, table, lens, window)
        _opcheck(torch.ops.repro_torch.paged_attention.default, args)
        assert torch.equal(torch.ops.repro_torch.paged_attention(*args),
                           paged_ops.paged_attention(*args[:5], window=window))


def test_meta_stand_ins_take_the_kernel_route_and_launch_nothing():
    launches = (gmm_ops.launches, packed_ops.launches_fwd, paged_ops.launches)
    out = gmm_ops.gmm(meta(2, 8, 16), meta(2, 16, 8), meta(2, dtype=torch.int32))
    att = packed_ops.packed_attention(*(meta(1, 64, 2, 32, dtype=torch.bfloat16),) * 3,
                                      meta(1, 64, dtype=torch.int32),
                                      meta(1, 64, dtype=torch.int32))
    assert out.shape == (2, 8, 8) and att.shape == (1, 64, 2, 32)
    assert (gmm_ops.launches, packed_ops.launches_fwd, paged_ops.launches) == launches


def test_visible_pairs_count_the_plain_mask():
    from repro_torch.kernels.packed_attention.ref import visible_mask

    for Sq, Skv, causal, window in [(7, 7, True, 0), (5, 9, True, 3), (9, 5, True, 0),
                                    (6, 6, False, 2), (4, 6, False, 0)]:
        ones_q, ones_kv = torch.ones(3, Sq, dtype=torch.int32), torch.ones(3, Skv,
                                                                            dtype=torch.int32)
        want = int(visible_mask(ones_q, ones_kv, causal=causal, window=window).sum())
        assert packed_ops.visible_pairs(3, Sq, Skv, causal, window) == want


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_count_on_stand_ins_equals_the_count_on_the_card():
    """One smoke-size olmo-1b train step and decode step in bf16: the FLOPs
    counted on meta stand-ins equal ``FlopCounterMode``'s count of the same
    steps run on the card (the same ops are dispatched)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import init_params
    from repro_torch.models.registry import make_batch
    from repro_torch.training import init_opt_state

    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    specs = model.param_specs()
    B, S = 2, 128
    step = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    _, fake = analyze_step(step, abstract_params(specs),
                           {"m": abstract_params(specs), "v": abstract_params(specs),
                            "step": meta(dtype=torch.int32)},
                           input_specs(cfg, ShapeConfig("s", "train", S, B)))
    dev = torch.device("cuda")
    params = init_params(specs, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: v.to(dev) for k, v in make_batch(cfg, "train", B, S).items()}
    with FlopCounterMode(display=False) as fc:
        step(params, init_opt_state(params), batch)
    torch.cuda.synchronize()
    assert fake.flops == fc.get_total_flops() > 0


def _adamw_state(specs):
    return {"m": abstract_params(specs), "v": abstract_params(specs),
            "step": meta(dtype=torch.int32)}


def test_train_step_peaks_in_the_update_of_the_last_leaf_in_sorted_order():
    """A stack of identical layers (olmo-1b smoke, 4 layers, a vocabulary
    of 2048 so that the embedding is the largest leaf), one train step
    under remat ``"nothing"`` on one row of 16 tokens.  Its activations are
    small: the step peaks in AdamW's update of the last leaf it walks, with
    every other leaf's new m, v and parameter written, that leaf's new m
    and v, and its ``m * mhat``, ``v * vhat`` and ``sqrt(v * vhat)`` live
    beside the arguments and the bf16 gradients: arguments + gradients +
    3 x the fp32 parameters + 2 x the last leaf + the scalars (11 of 4
    bytes on the card).  The optimizer walks the trees in their dicts'
    order, which ``init_params`` (the card's parameters) makes sorted: the
    embedding comes last.  Stand-ins in the specs' order walked a feed-
    forward leaf last, and olmo-1b's train step read 4.2% over the card.
    The count on real CPU tensors from ``init_params`` peaks the same, and
    the count's ``top_held`` listing names what is live at the peak."""
    import dataclasses
    import math

    from repro_torch.models import init_params
    from repro_torch.models.params import tree_paths
    from repro_torch.models.registry import make_batch
    from repro_torch.training import init_opt_state

    cfg = dataclasses.replace(get_config("olmo-1b").smoke(), n_layers=4, vocab_size=2048)
    model = build_model(cfg)
    specs = model.param_specs()
    step = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    _, cost = analyze_step(step, abstract_params(specs), _adamw_state(specs),
                           input_specs(cfg, ShapeConfig("s", "train", 16, 1)), top_held=5)
    # the debug listing: the five largest storages at the peak are the
    # embedding's new m and v and its three temporaries
    assert sorted(op for op, *_ in cost.held_at_peak) == ["add", "add", "mul", "mul", "sqrt"]
    assert {(shape, dtype) for _, shape, dtype, _ in cost.held_at_peak} == {
        ((cfg.vocab_size, cfg.d_model), "float32")}
    paths = tree_paths(specs)
    sizes = [math.prod(spec.shape) for _, spec in paths]
    assert paths[-1][0] == ("embed",) and sizes[-1] == max(sizes) > min(sizes)
    want = cost.arg_bytes + 2 * sum(sizes) + 3 * 4 * sum(sizes) + 2 * 4 * sizes[-1]
    assert want <= cost.peak_bytes <= want + 11 * 4

    params = init_params(specs, torch.Generator().manual_seed(0))
    _, real = analyze_step(step, params, init_opt_state(params), make_batch(cfg, "train", 1, 16))
    assert (real.peak_bytes, real.arg_bytes) == (cost.peak_bytes, cost.arg_bytes)


@pytest.mark.cuda
def test_train_step_peak_on_stand_ins_is_the_cards():
    """olmo-1b at full width, 2 of its 16 layers, a train step on one row
    of 512 tokens: the peak counted on meta stand-ins within 1.5% of the
    card's, read as ``chip_smoke.py`` phase 11c reads it (after a warm-up
    step: ``max_memory_allocated()`` less what the process holds beside the
    step's arguments)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    import gc

    from repro_torch.models import init_params
    from repro_torch.models.registry import make_batch
    from repro_torch.training import init_opt_state

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=2)
    model = build_model(cfg)
    specs = model.param_specs()
    step = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    _, cost = analyze_step(step, abstract_params(specs), _adamw_state(specs),
                           input_specs(cfg, ShapeConfig("s", "train", 512, 1)))
    dev = torch.device("cuda")
    params = init_params(specs, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: v.to(dev) for k, v in make_batch(cfg, "train", 1, 512).items()}
    opt_state = init_opt_state(params)
    params, opt_state, _ = step(params, opt_state, batch)  # warm-up
    held = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tree_leaves((params, opt_state, batch))
                if isinstance(t, torch.Tensor)}.values())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    beside = torch.cuda.memory_allocated() - held
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - beside
    assert abs(cost.peak_bytes - peak) <= 0.015 * peak, (cost.peak_bytes, peak)


# ---------------------------------------------------------------------------
# prefill cells: the write plan from shapes, every family, the FLOP oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,page_size", [(3, 16, 4), (2, 10, 4), (4, 7, 16)])
def test_write_plan_from_shapes_equals_the_plan_from_values(B, S, page_size):
    """A stand-in's plan is read from its shape (every row full, row b on
    pages b P ... (b + 1) P - 1): the plan ``write_plan`` reads from real
    all-ones segment ids, slot for slot, and the allocator's own pages."""
    from repro_torch.models.transformer import full_rows_plan, write_plan
    from repro_torch.serving.kv_cache import PageAllocator, PagedCacheLayout

    P = -(-S // page_size)
    layout = PagedCacheLayout(num_pages=B * P, page_size=page_size, n_kv_heads=1,
                              head_dim=8, max_pages_per_seq=P)
    from_values = write_plan(PageAllocator(layout), torch.ones((B, S), dtype=torch.int32))
    alloc = PageAllocator(layout)
    from_shapes = full_rows_plan(alloc, B, S, "cpu")
    for a, b in zip(from_shapes[:4], from_values[:4], strict=True):
        assert torch.equal(a.long(), b.long())
    assert from_shapes.full_rows and from_values.full_rows
    assert [alloc.seq_pages(b) for b in range(B)] == [
        list(range(b * P, (b + 1) * P)) for b in range(B)]
    on_meta = write_plan(PageAllocator(layout), meta(B, S, dtype=torch.int32))
    assert on_meta.full_rows and on_meta.dest.device.type == "meta"
    assert on_meta.dest.shape == from_values.dest.shape


def test_prefill_step_flops_match_jax():
    """olmo-1b at smoke size, a prefill of 2 x 64 tokens counted on meta
    stand-ins, against ``analyze_hlo_text`` of the JAX package's prefill:
    equal but for the attention, which JAX computes dense (4 B H S^2 D a
    layer) and the packed kernel's formula counts over the visible pairs
    (4 H D B S (S + 1) / 2 a layer)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.launch.hlo_analysis import analyze_hlo_text
    from repro.models import build_model as jax_build_model
    from repro.models import init_params as jax_init_params
    from repro.models.registry import make_batch as jax_make_batch

    B, S = 2, 64
    jcfg = jax_get_config("olmo-1b").smoke()
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    jb = {k: v for k, v in jax_make_batch(jcfg, "prefill", B, S).items() if k != "labels"}
    jax_flops = analyze_hlo_text(
        jax.jit(jm.prefill).lower(jp, jb).compile().as_text()).flops
    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    shape = ShapeConfig("smoke", "prefill", S, B)
    _, cost = analyze_step(model.prefill, abstract_params(model.param_specs()),
                           input_specs(cfg, shape),
                           cache_specs(cfg, shape, dtype=torch.float32))
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.head_dim_
    port_attn = 4 * D * H * (B * S * (S + 1) // 2) * L
    jax_attn = 4 * B * H * S * S * D * L
    assert cost.flops_by_op["repro_torch.packed_attention_fwd"] == port_attn
    assert cost.flops - port_attn == pytest.approx(jax_flops - jax_attn, rel=1e-12)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                                  "xlstm-125m", "seamless-m4t-medium", "internvl2-1b"])
def test_prefill_cell_of_each_family_counts_on_one_rank(fake_group, arch):
    """One prefill cell of each family (dense, MoE, hybrid, recurrent,
    encoder-decoder, vision) at full width on the one-card (1, 1) mesh of
    stand-ins: 2 full rows of 256 tokens (two chunks of the recurrent
    scans), the cache an argument, every attention layer through the packed
    kernel's operator."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_group(1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config(arch)
    shape = ShapeConfig("prefill_small", "prefill", 256, 2)
    rec = dryrun.lower_cell(arch, "prefill_small", mesh=mesh, shape=shape, keep_hlo=True)
    by_op = rec["_cost"].flops_by_op
    assert rec["kind"] == "prefill" and rec["flops_per_dev"] > 0
    assert rec["collectives"]["total"] == 0
    assert rec["cache_bytes_global"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["cache_bytes_global"]
    assert rec["dominant"] in ("compute", "memory")
    if "A" in cfg.pattern or cfg.encdec:
        assert by_op["repro_torch.packed_attention_fwd"] > 0
    if cfg.moe is not None:
        assert by_op["repro_torch.gmm"] > 0


# ---------------------------------------------------------------------------
# the recurrent scans counted from one chunk
# ---------------------------------------------------------------------------

_COUNTS = ("flops", "dot_bytes", "eager_bytes", "ops", "peak_bytes", "out_bytes",
           "coll_count")


def _scaled_and_full(fn, *args):
    """``fn`` counted on meta stand-ins (a scan runs its first chunk and is
    counted for all) and on CPU zeros of the same shapes (every chunk runs):
    the count goes by shape, so the two must agree."""
    zeros = tree_map_only(torch.Tensor, lambda t: torch.zeros(t.shape, dtype=t.dtype), args)
    return analyze_step(fn, *args)[1], analyze_step(fn, *zeros)[1]


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_scan_counted_from_one_chunk_equals_the_full_loop(mixer):
    """The recurrent mixers' scans at L = 512 in chunks of 128, counted from
    the first chunk (``chunked_scan`` of stand-ins under the counting mode)
    and by running every chunk on zeros: FLOPs, bytes, ops and peak exactly
    equal."""
    from repro_torch.models import ssm, xlstm

    arch, specs, fwd = {
        "mamba": ("jamba-v0.1-52b", ssm.mamba_specs, ssm.mamba_forward),
        "mlstm": ("xlstm-125m", xlstm.mlstm_specs, xlstm.mlstm_forward),
        "slstm": ("xlstm-125m", xlstm.slstm_specs, xlstm.slstm_forward),
    }[mixer]
    cfg = get_config(arch).smoke()
    scaled, full = _scaled_and_full(lambda p, x: fwd(p, cfg, x, chunk_size=128),
                                    abstract_params(specs(cfg)), meta(2, 512, cfg.d_model))
    for f in _COUNTS:
        assert getattr(scaled, f) == getattr(full, f), f
    assert scaled.flops_by_op == full.flops_by_op and scaled.flops > 0


@pytest.mark.parametrize("L,chunk", [(64, 4), (30, 4), (512, 128)])
def test_scan_counted_from_one_chunk_peaks_as_the_full_loop(L, chunk):
    """A scan whose steps hold a temporary larger than the outputs, so that
    its peak falls inside the last chunk (or after the loop, at 512 / 128):
    the count from one chunk of stand-ins peaks where the full loop on
    zeros does, padded steps included (L = 30)."""
    from repro_torch.models.scan_utils import chunked_scan

    def step(h, x):
        tmp = h[:, :, None] * h[:, None, :]  # (B, 64, 64), freed each step
        h = h + (tmp @ h[..., None])[..., 0] * x.sum(-1, keepdim=True)
        return h, h[:, :8] * x

    scaled, full = _scaled_and_full(
        lambda h0, xs: chunked_scan(step, h0, xs, chunk_size=chunk), meta(2, 64),
        meta(L, 2, 8))
    for f in _COUNTS:
        assert getattr(scaled, f) == getattr(full, f), f
    assert scaled.flops == -(-L // chunk) * chunk * 2 * 2 * 64 * 64


def test_scan_counted_from_one_chunk_matches_jax_trip_count():
    """The JAX module multiplies a scan's body by its trip count; the
    port's count of ``chunked_scan`` of the same products, run for one chunk
    and counted for all, gives the same FLOPs."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo_text
    from repro_torch.models.scan_utils import chunked_scan

    def f(c, xs):
        return jax.lax.scan(lambda c, x: (c @ x, None), c, xs)[0]

    hlo = jax.jit(f).lower(jnp.zeros((64, 64)), jnp.zeros((96, 64, 64))).compile().as_text()
    _, cost = analyze_step(
        lambda c, xs: chunked_scan(lambda c, x: (c @ x, c[:1]), c, xs, chunk_size=32)[0],
        meta(64, 64), meta(96, 64, 64))
    assert cost.flops == 96 * 2 * 64 ** 3
    assert analyze_hlo_text(hlo).flops == pytest.approx(cost.flops, rel=0.05)


# ---------------------------------------------------------------------------
# the page-local prefill write on four gloo ranks
# ---------------------------------------------------------------------------

_PREFILL_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import batch_shardings, cache_shardings, make_rules
    from repro_torch.distributed import param_shardings
    from repro_torch.distributed.context import activation_sharding
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving.kv_cache import PagedCacheLayout

    def main(rank):
        dist.init_process_group("gloo", init_method=sys.argv[1], rank=rank, world_size=4)
        torch.set_num_threads(1)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh)
        res = {}
        for arch in ("olmo-1b", "qwen3-8b"):
            cfg = get_config(arch).smoke()
            model = build_model(cfg)
            specs = model.param_specs()
            params = init_params(specs, torch.Generator().manual_seed(0), torch.float32, "cpu")
            a = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[2]).items()}
            layout = PagedCacheLayout(num_pages=16, page_size=4, n_kv_heads=cfg.n_kv_heads,
                                      head_dim=cfg.head_dim_, max_pages_per_seq=4)
            cache = model.init_paged_cache(layout, torch.float32)
            c_shard = cache_shardings(cache, mesh, rules)
            for key in ("k", "v"):
                cache[key] = distribute(cache[key], c_shard[key])
            b_shard = batch_shardings(a, mesh, rules)
            batch = {k: distribute(v, b_shard[k]) for k, v in a.items()}
            dparams = tree_map(distribute, params, param_shardings(specs, mesh, rules))
            with activation_sharding(mesh, rules), implicit_replication():
                logits, cache = model.prefill(dparams, batch, cache)
            res[arch + "/logits"] = logits.full_tensor().numpy()
            res[arch + "/k"] = cache["k"].full_tensor().numpy()
            res[arch + "/v"] = cache["v"].full_tensor().numpy()
            res[arch + "/placements"] = np.array([str(cache["k"].placements)])
        if rank == 0:
            np.savez(sys.argv[3], **res)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.spawn(main, nprocs=4)
''')


@pytest.mark.timeout(300)
def test_prefill_on_four_ranks_writes_each_ranks_own_pages(tmp_path):
    """Four gloo ranks on a (2, 2) mesh, 4 full rows of 16 tokens, the
    pools' 16 pages sharded four ways by page: each rank writes the K/V of
    its rows' tokens into the pages it holds (olmo-1b's 4 KV heads, laid
    out over ``model``, cross in one all-to-all; qwen3-8b's one KV head is
    on every rank).  The gathered pools and the logits equal the prefill on
    one process, within 1e-5 of their largest values (fp32; the mesh sums
    in another order)."""
    import socket

    from repro_torch.models import init_params
    from repro_torch.serving.kv_cache import PagedCacheLayout

    B, S = 4, 16
    rng = np.random.default_rng(3)
    a = {"tokens": rng.integers(1, 256, size=(B, S)).astype(np.int32),
         "segment_ids": np.ones((B, S), np.int32),
         "positions": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()}
    inputs = tmp_path / "in.npz"
    np.savez(inputs, **a)
    script = tmp_path / "worker.py"
    script.write_text(_PREFILL_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), f"tcp://localhost:{port}",
                          str(inputs), str(tmp_path / "out.npz")],
                         capture_output=True, text=True, timeout=270, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    for arch in ("olmo-1b", "qwen3-8b"):
        cfg = get_config(arch).smoke()
        model = build_model(cfg)
        params = init_params(model.param_specs(), torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
        layout = PagedCacheLayout(num_pages=16, page_size=4, n_kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.head_dim_, max_pages_per_seq=4)
        logits, cache = model.prefill(params, {k: torch.from_numpy(v) for k, v in a.items()},
                                      model.init_paged_cache(layout, torch.float32))
        assert "Shard(dim=1), Shard(dim=1)" in str(got[arch + "/placements"][0])
        for key, want in (("logits", logits), ("k", cache["k"]), ("v", cache["v"])):
            want = want.numpy()
            assert np.abs(got[f"{arch}/{key}"] - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the recurrent train cells counted from one chunk
# ---------------------------------------------------------------------------
#
# Under autograd a scan of stand-ins runs its first chunk between two
# identities whose backwards bracket the chunk's (trace_analysis._ChunkStart,
# _ChunkEnd), and counts its forward and its backward (the checkpoint's
# recompute and the gradients) once for every chunk.  The FLOPs are the
# full loop's exactly: each chunk runs the same ops on the same shapes.  The
# peak is modelled (the other chunks' carries and input gradients allocated
# uncounted), so it is held within TRAIN_PEAK_TOL of the full loop's:
# measured here within 1.6% (xlstm, 12 layers at 512 tokens, -1.6%; the
# mixers alone within +0.6%).

TRAIN_PEAK_TOL = 0.03
TRAIN_CHUNK = 16  # the mixers' scans in chunks of 16: 4 chunks of 64 tokens


def _small_chunks(monkeypatch):
    """The recurrent mixers with their scans in chunks of ``TRAIN_CHUNK``."""
    import functools

    from repro_torch.models import ssm, transformer, xlstm

    fns = {"M": ssm.mamba_forward, "l": xlstm.mlstm_forward, "s": xlstm.slstm_forward}
    monkeypatch.setattr(transformer, "_RECURRENT", {
        c: (functools.partial(fns[c], chunk_size=TRAIN_CHUNK), step)
        for c, (_, step) in transformer._RECURRENT.items()})


def _one_period(arch):
    import dataclasses

    cfg = get_config(arch).smoke()
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


def _configs(monkeypatch, cfg):
    """``lower_cell`` (and its roofline terms) building ``cfg``."""
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_train_cell_counted_from_one_chunk_equals_the_full_loop(fake_group, monkeypatch,
                                                                  arch):
    """The smoke train_4k cell (one period of the pattern, 2 rows of 64
    tokens, scans in 4 chunks of 16) on a (2, 1) mesh of a fake group, so
    that jamba's MoE layers dispatch two groups through the einsum (one
    group takes the kernel route, which has no backward): counted from one
    chunk, and with every chunk run (stand-ins taken for real tensors):
    FLOPs, collectives and their count equal, the peak within
    TRAIN_PEAK_TOL."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import scan_utils

    _small_chunks(monkeypatch)
    _configs(monkeypatch, _one_period(arch))
    shape = ShapeConfig("train_4k", "train", 64, 2)
    costs = []
    for full_loop in (False, True):
        if full_loop:
            monkeypatch.setattr(scan_utils, "_is_meta", lambda t: False)
        fake_group(2)
        mesh = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
        costs.append(dryrun.lower_cell(arch, "train_4k", mesh=mesh, shape=shape,
                                       keep_hlo=True)["_cost"])
        dist.destroy_process_group()
    scaled, full = costs
    assert scaled.flops == full.flops > 0
    assert scaled.flops_by_op == full.flops_by_op
    assert scaled.coll_count == full.coll_count and scaled.coll == full.coll
    assert abs(scaled.peak_bytes - full.peak_bytes) <= TRAIN_PEAK_TOL * full.peak_bytes


def test_train_step_counted_from_one_chunk_equals_flop_counter_mode(monkeypatch):
    """xlstm-125m's smoke train step (one period, 2 x 64 tokens, 4 chunks
    of 16) on meta stand-ins, its scans counted from one chunk, against
    ``FlopCounterMode`` over the full loop run on CPU zeros."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import init_params
    from repro_torch.models.registry import make_batch
    from repro_torch.training import init_opt_state

    _small_chunks(monkeypatch)
    cfg = _one_period("xlstm-125m")
    model = build_model(cfg)
    specs = model.param_specs()
    step = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    _, scaled = analyze_step(step, abstract_params(specs),
                             {"m": abstract_params(specs), "v": abstract_params(specs),
                              "step": meta(dtype=torch.int32)},
                             input_specs(cfg, ShapeConfig("s", "train", 64, 2)))
    params = init_params(specs, torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        step(params, init_opt_state(params), make_batch(cfg, "train", 2, 64))
    assert scaled.flops == fc.get_total_flops() > 0


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_prefill_collectives_do_not_scale_with_the_sequence(fake_group, monkeypatch, arch):
    """A prefill of the smoke model on a (2, 2) mesh of a fake group, its
    scans on each rank's own rows and channels: the same collective calls
    at S and at 2S tokens (a scan step that moved data would add calls
    with every token)."""
    from torch.distributed.device_mesh import init_device_mesh

    _configs(monkeypatch, get_config(arch).smoke())
    counts = []
    for S in (16, 32):
        fake_group(4)
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.lower_cell(arch, "prefill", mesh=mesh,
                                shape=ShapeConfig("prefill", "prefill", S, 4))
        dist.destroy_process_group()
        counts.append(rec["collectives"]["count"])
    assert counts[0] == counts[1]
