"""The port's serving path on the CPU against the JAX package's.

The JAX package's own parameters (``init_params(PRNGKey(0))``) are carried
into the port through numpy (``params_from_numpy``), so both packages run
the same weights, in f32, at ``qwen3-8b.smoke()`` (GQA, G = 4, qk-RMSNorm)
and ``olmo-1b.smoke()`` (MHA, non-parametric LayerNorm, tied embeddings).

Tolerance: ``tests/test_kernels.py``'s f32 TOLS (2e-5), on logits of order
1.  Both packages compute in f32 and differ only in summation order; the
largest gap measured on these configurations is 1.8e-6.

Ragged rows are prefilled packed into one row (``transformer.pack_rows``);
the tests hold that path to JAX and to the row path, which ``rows_only``
forces, and show which batches keep their rows.

The decode oracle is JAX ``decode_step`` on the prefill's dense cache
zero-padded to hold the new tokens, or JAX ``prefill`` of the longer
prompt.  It is never JAX's own prefill-to-decode hand-off: that cache is
exactly as long as the prompt, so ``attention_decode`` scatters each new
token past its end and JAX drops the write (see
``test_jax_unpadded_hand_off_drops_the_new_tokens``).
"""

import argparse
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.launch.serve import run_sim as jax_run_sim
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.layers import flash_attention as jax_flash
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.layers import flash_attention
from repro_torch.models.params import Spec
from repro_torch.obs import spans
from repro_torch.serving.kv_cache import PagedCacheLayout

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["qwen3-8b", "olmo-1b"]


def ragged_cases(first):
    """(arch, lens) for ``first`` and for prompts across page edges (pages
    of 4), ids as the arch alone for ``first``."""
    cases = [(arch, lens) for lens in (first, [5, 17, 16, 33]) for arch in ARCHS]
    return dict(argvalues=cases, ids=[
        arch if lens == first else f"{arch}-{'-'.join(map(str, lens))}" for arch, lens in cases])


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_config(arch).smoke()
            jm = jax_build_model(jax_get_config(arch).smoke())
            jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp))
            cache[arch] = (cfg, jm, jp, build_model(cfg), tp)
        return cache[arch]

    return get


def ragged_batch(rng, vocab, lens, width):
    """Prompts of ``lens`` tokens, right-padded with segment 0 to ``width``."""
    B = len(lens)
    tokens = np.zeros((B, width), np.int32)
    seg = np.zeros((B, width), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, vocab, size=n)
        seg[b, :n] = 1
    pos = np.broadcast_to(np.arange(width, dtype=np.int32), (B, width)).copy()
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def paged_cache(model, cfg, num_pages=64, page_size=4):
    layout = PagedCacheLayout(num_pages=num_pages, page_size=page_size,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                              max_pages_per_seq=16)
    return model.init_paged_cache(layout, dtype=torch.float32)


@contextlib.contextmanager
def rows_only():
    """Prefill on the padded rows whatever the batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer.DecoderLM, "_packs", lambda *args: False)
        yield


def packed_prefills(fn):
    """``fn()`` under a profiler session, and how many prefills it packed."""
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, sum(r.value for r in spans.drain()
                    if isinstance(r, spans.Count) and r.name == "prefill.packed")


def slots(cache, b):
    """Sequence b's slots in a pool flattened over (page, slot), in order."""
    alloc = cache["alloc"]
    ps = alloc.layout.page_size
    return [p * ps + i for p in alloc.seq_pages(b) for i in range(ps)][:alloc.seq_len(b)]


def jax_padded_cache(jcache, extra):
    """JAX's prefill cache zero-padded by ``extra`` slots along the sequence."""
    pad = [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)]
    blocks = jax.tree.map(lambda a: jnp.pad(a, pad), jcache["blocks"])
    return {"blocks": blocks, "len": jcache["len"]}


# ---------------------------------------------------------------------------
# configs, parameters, registry
# ---------------------------------------------------------------------------


def test_configs_are_the_jax_packages():
    assert ARCH_NAMES == JAX_ARCH_NAMES
    for name in ARCH_NAMES:
        for cfg, ref in ((get_config(name), jax_get_config(name)),
                         (get_config(name).smoke(), jax_get_config(name).smoke())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
            assert cfg.param_counts() == ref.param_counts()


@pytest.mark.parametrize("arch", JAX_ARCH_NAMES)
def test_param_specs_match_jax_at_full_width(arch):
    def flat(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{path}/{k}"))
            return out
        return {path: (tuple(tree.shape), tree.axes, tree.init, tree.scale)}

    specs = build_model(get_config(arch)).param_specs()
    jspecs = jax_build_model(jax_get_config(arch)).param_specs()
    assert flat(specs) == flat(jspecs)


def test_init_params_follows_the_jax_rules():
    specs = {
        "z": Spec((3, 5), (None, None), init="zeros"),
        "o": Spec((4,), (None,), init="ones"),
        "n": Spec((256, 64), (None, None), init="normal", scale=0.5),
        # fan-in from shape[-2]: 16, not 64 * 16
        "s": Spec((64, 16, 32), (None, None, None), init="scaled"),
        "empty": {},
    }
    gen = torch.Generator().manual_seed(0)
    p = init_params(specs, gen, torch.float32)
    assert p["empty"] == {}
    assert (p["z"] == 0).all() and (p["o"] == 1).all()
    assert abs(p["n"].std().item() - 0.5) < 0.02
    assert abs(p["s"].std().item() - 1 / 4) < 0.01
    again = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert again["s"].dtype == torch.bfloat16
    torch.testing.assert_close(again["s"], p["s"].to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_models_build_with_the_jax_specs(arch):
    """The MoE decoders build, every layer's feed-forward an MoE layer whose
    specs are the JAX package's at full width."""
    model = build_model(get_config(arch))
    specs = model.param_specs()
    jspecs = jax_build_model(jax_get_config(arch)).param_specs()
    ffn = specs["blocks"]["0"]["ffn"]
    assert "router" in ffn and ffn["w_up"].shape[:2] == (
        model.cfg.n_layers, model.cfg.moe.num_experts)
    assert {k: (s.shape, s.axes, s.init) for k, s in ffn.items()} == {
        k: (s.shape, s.axes, s.init) for k, s in jspecs["blocks"]["0"]["ffn"].items()}


# ---------------------------------------------------------------------------
# prefill and paged decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_flash_attention_matches_jax_across_chunks(causal, window):
    """Chunks of 8 over 40 packed tokens: the online-softmax carry across
    KV chunks, the causal chunk skip, padded rows and GQA."""
    rng = np.random.default_rng(6)
    B, S, H, KVH, D = 2, 40, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, n, D)).astype(np.float32)
               for n in (H, KVH, KVH))
    seg = np.zeros((B, S), np.int32)
    seg[0, :15], seg[0, 15:33] = 1, 2      # two packed documents, then pad
    seg[1, :27] = 1
    kw = dict(causal=causal, window=window, chunk_q=8, chunk_kv=8)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, seg, seg)), **kw)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, seg, seg)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[0, 33:] == 0).all() and (got[1, 27:] == 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, built):
    cfg, jm, jp, model, tp = built(arch)
    batch = ragged_batch(np.random.default_rng(0), cfg.vocab_size, [12, 12], 12)
    want, _ = jm.prefill(jp, to_jax(batch))
    got, cache = model.prefill(tp, to_torch(batch), paged_cache(model, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["len"].tolist() == [12, 12]


@pytest.mark.parametrize("arch,lens", **ragged_cases([20, 13, 7, 1]))
def test_ragged_prefill_matches_jax(arch, lens, built):
    """Ragged rows, prefilled packed, against JAX's prefill and the row
    path: the logits, every layer's K/V at each sequence's slots, the
    lengths and the pages."""
    cfg, jm, jp, model, tp = built(arch)
    batch = ragged_batch(np.random.default_rng(1), cfg.vocab_size, lens, max(lens))
    want, jcache = jm.prefill(jp, to_jax(batch))
    (got, cache), packed = packed_prefills(
        lambda: model.prefill(tp, to_torch(batch), paged_cache(model, cfg)))
    with rows_only():
        rows, row_cache = model.prefill(tp, to_torch(batch), paged_cache(model, cfg))
    assert packed == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), rows.numpy(), **TOL)
    for name in ("k", "v"):
        jax_kv = np.asarray(jcache["blocks"]["0"][name])  # (layers, B, S, KVH, D)
        np.testing.assert_allclose(cache[name].numpy(), row_cache[name].numpy(), **TOL)
        # K/V reach ~30, where TOL is for values of order 1: both paths sit
        # within 2e-6 of the largest, so the gap is taken over it
        scale = np.abs(jax_kv).max()
        for b, n in enumerate(lens):
            got_kv = cache[name].flatten(1, 2)[:, slots(cache, b)].numpy()
            np.testing.assert_allclose(got_kv / scale, jax_kv[:, b, :n] / scale, **TOL)
    assert cache["len"].tolist() == row_cache["len"].tolist() == lens
    alloc = cache["alloc"]
    assert [alloc.seq_len(b) for b in range(len(lens))] == lens
    assert [alloc.seq_pages(b) for b in range(len(lens))] == [
        row_cache["alloc"].seq_pages(b) for b in range(len(lens))]
    # First-Fit on a fresh pool: rows take consecutive low pages
    assert alloc.highest_used_page() == alloc.used_pages == sum(
        alloc.layout.pages_for(n) for n in lens)


@pytest.mark.parametrize("arch,lens", **ragged_cases([20, 13, 7]))
def test_paged_decode_matches_jax_on_a_padded_cache(arch, lens, built):
    """Decode after a packed prefill of ragged rows."""
    cfg, jm, jp, model, tp = built(arch)
    rng = np.random.default_rng(2)
    steps = 4
    batch = ragged_batch(rng, cfg.vocab_size, lens, max(lens))
    _, jcache = jm.prefill(jp, to_jax(batch))
    jcache = jax_padded_cache(jcache, steps)
    _, cache = model.prefill(tp, to_torch(batch), paged_cache(model, cfg))
    before = ops.launches
    for _ in range(steps):
        tok = rng.integers(1, cfg.vocab_size, size=(len(lens), 1)).astype(np.int32)
        want, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jcache)
        got, cache = model.decode_step(tp, {"tokens": torch.from_numpy(tok)}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["len"].tolist() == [n + steps for n in lens]
    assert ops.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_paged_decode_matches_jax_prefill(arch, built):
    cfg, jm, jp, model, tp = built(arch)
    T, extra = 9, 5
    batch = ragged_batch(np.random.default_rng(3), cfg.vocab_size, [T + extra],
                         T + extra)
    want, _ = jm.prefill(jp, to_jax(batch))
    short = {k: v[:, :T] for k, v in batch.items()}
    _, cache = model.prefill(tp, to_torch(short), paged_cache(model, cfg))
    for t in range(T, T + extra):
        tok = torch.from_numpy(batch["tokens"][:, t:t + 1].copy())
        got, cache = model.decode_step(tp, {"tokens": tok}, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_jax_unpadded_hand_off_drops_the_new_tokens(built):
    """The reference-side fault: JAX's prefill cache is as long as the prompt,
    so decode writes each new token's K/V out of bounds and JAX drops it.
    The port appends into its pages and matches the padded-cache oracle."""
    cfg, jm, jp, model, tp = built("qwen3-8b")
    rng = np.random.default_rng(4)
    batch = ragged_batch(rng, cfg.vocab_size, [6], 6)
    _, jcache = jm.prefill(jp, to_jax(batch))
    padded = jax_padded_cache(jcache, 2)
    _, cache = model.prefill(tp, to_torch(batch), paged_cache(model, cfg))
    for _ in range(2):
        tok = rng.integers(1, cfg.vocab_size, size=(1, 1)).astype(np.int32)
        dropped, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jcache)
        want, padded = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, padded)
        got, cache = model.decode_step(tp, {"tokens": torch.from_numpy(tok)}, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(np.asarray(dropped) - np.asarray(want)).max() > 0.05


# batches that keep their rows: (arch, lens, width, what changes the config)
KEEP_ROWS = {
    "full-rows": ("qwen3-8b", [12, 12], 12, {}),
    "single-request": ("qwen3-8b", [9], 9, {}),
    "moe": ("qwen3-moe-30b-a3b", [9, 5, 3], 9, {}),
    "recurrent-hybrid": ("jamba-v0.1-52b", [9, 5, 3], 9, {"moe": None}),
    "vision-embeds": ("internvl2-1b", [12, 9, 10], 12, {}),
}


@pytest.mark.parametrize("case", list(KEEP_ROWS))
def test_prefill_keeps_rows_where_packing_would_change_the_result(case):
    """Full rows, a single request, MoE layers (an expert's capacity counts
    padding), recurrent layers (a state is a row's) and vision embeddings
    (the rows' first positions) keep the padded rows: nothing is packed,
    and every output is the row path's, bit for bit."""
    arch, lens, width, change = KEEP_ROWS[case]
    cfg = dataclasses.replace(get_config(arch).smoke(), **change)
    model = build_model(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0))
    batch = to_torch(ragged_batch(np.random.default_rng(6), cfg.vocab_size, lens, width))
    if cfg.frontend == "vision":
        batch["vision_embeds"] = 0.02 * torch.randn(
            len(lens), cfg.frontend_tokens, cfg.d_model, generator=torch.Generator().manual_seed(1))
    (got, cache), packed = packed_prefills(
        lambda: model.prefill(params, batch, paged_cache(model, cfg)))
    with rows_only():
        want, row_cache = model.prefill(params, batch, paged_cache(model, cfg))
    assert packed == 0
    assert torch.equal(got, want)
    for name in ("k", "v", "len"):
        assert torch.equal(cache[name], row_cache[name])
    for a, b in zip(cache["state"], row_cache["state"], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_prefill_packs_only_values_on_one_device():
    """The gate reads the plan and the segment ids: ragged rows pack; the
    same ids on the meta device (a dry-run's stand-ins, planned as full
    rows) or as a DTensor (a mesh's) do not."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_config("qwen3-8b").smoke()
    model = build_model(cfg)
    batch = to_torch(ragged_batch(np.random.default_rng(7), cfg.vocab_size, [6, 3], 6))
    plan = transformer.write_plan(paged_cache(model, cfg)["alloc"], batch["segment_ids"])
    assert model._packs(batch, plan)
    meta = dict(batch, segment_ids=batch["segment_ids"].to("meta"))
    assert not model._packs(meta, transformer.write_plan(paged_cache(model, cfg)["alloc"],
                                                         meta["segment_ids"]))
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        seg = distribute_tensor(batch["segment_ids"], mesh, [Replicate()])
        assert not model._packs(dict(batch, segment_ids=seg), plan)
    finally:
        torch.distributed.destroy_process_group()


def test_prefill_needs_an_empty_cache_and_decode_a_free_page(built):
    cfg, _, _, model, tp = built("qwen3-8b")
    batch = to_torch(ragged_batch(np.random.default_rng(5), cfg.vocab_size, [8], 8))
    cache = paged_cache(model, cfg, num_pages=2, page_size=4)
    _, cache = model.prefill(tp, batch, cache)
    with pytest.raises(ValueError, match="holds no sequence"):
        model.prefill(tp, batch, cache)
    with pytest.raises(RuntimeError, match="cannot grow"):
        model.decode_step(tp, {"tokens": batch["tokens"][:, :1]}, cache)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_run_sim_prints_the_jax_line(capsys):
    argv = ["--backend", "sim", "--requests", "40", "--replicas", "3"]
    serve.main(argv)
    got = capsys.readouterr().out
    ns = argparse.Namespace(**{**vars(serve.parse_args(argv))})
    jax_run_sim(ns)
    assert got == capsys.readouterr().out
    assert got.startswith("completed 40/40")


def test_run_local_on_the_cpu_at_smoke_size(capsys):
    before = ops.launches
    stats = serve.run_local(serve.parse_args(
        ["--backend", "local", "--smoke", "--device", "cpu", "--requests", "3",
         "--gen-tokens", "4", "--pages", "32"]))
    assert capsys.readouterr().out.startswith("served 3 sequences x 4 tokens in ")
    assert stats["tokens"].shape == (3, 5) and stats["logits_finite"]
    assert stats["pages_used"] == 3 * 2  # 20 tokens in 16-token pages
    assert ops.launches == before


def test_run_local_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--backend", "local", "--smoke"])
