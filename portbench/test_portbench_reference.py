"""The plain reference against the port's plain route (its CPU path) at
smoke widths, in float32: the loss, every gradient, prefill's logits and
K/V; and the reference packer against the port's pipeline, bit for bit."""

import itertools
import json

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.conftest import PACKAGE, smoke_config
from portbench.port import arch_config, from_port, to_port
from portbench.reference.judge import first_fit_pages, tokens_of_rows
from portbench.reference.model import Precision, Tokens, prefill, train_loss
from portbench.reference.packer import packed_rows
from portbench.weights import draw

TRAIN = json.loads((PACKAGE / "traffic" / "train-4k.json").read_text())
LAW = dict(TRAIN["documents"], mean_len=40, max_len=300)


def _model(cfg):
    from repro_torch.models import build_model
    return build_model(arch_config(cfg))


def _rows(cfg, seed, n, seq=128, rows=2):
    return list(itertools.islice(
        packed_rows(traffic.documents(LAW, cfg["vocab_size"], seed), seq, rows), n))


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-8b"])
def test_loss_and_gradients_match_the_port(name):
    # a vocabulary the port does not pad: its cross-entropy spans the padding
    # rows too, which the published model has not (no cell trains such a model)
    cfg = dict(smoke_config(name), vocab_size=256)
    cfg.setdefault("loss", {"z_loss": 1e-4})
    batch = _rows(cfg, 3, 1)[0]
    w = draw(cfg, 5, torch.float32, torch.device("cpu"))
    for t in w.values():
        t.requires_grad_(True)
    tok, labels = tokens_of_rows(batch, "cpu")
    ref = train_loss(cfg, w, tok, labels, Precision("fp32"), z_loss=cfg["loss"]["z_loss"])
    ref_g = dict(zip(w, torch.autograd.grad(ref, list(w.values()))))

    model = _model(cfg)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    params = to_port(leaves, model)
    got, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                        remat_policy=None)
    got_g = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()), allow_unused=True)))
    assert float(got.detach()) == pytest.approx(float(ref.detach()), rel=2e-6)
    for k in w:
        g, r = got_g[k], ref_g[k]
        assert float((g - r).norm() / r.norm()) < 2e-5, k


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-8b"])
def test_prefill_matches_the_port(name):
    from repro_torch.serving.kv_cache import PagedCacheLayout

    cfg = dict(smoke_config(name), page_size=16)
    lengths = [13, 40, 7]
    ids = traffic.prompt_ids(lengths, cfg["vocab_size"], 9)
    w = draw(cfg, 4, torch.float32, torch.device("cpu"))
    kv = {}
    ref = prefill(cfg, w, Tokens.from_documents(ids, "cpu"), Precision("fp32"),
                  lambda l, k, v: kv.__setitem__(l, (k, v)))

    model = _model(cfg)
    S = max(lengths)
    batch = {"tokens": torch.zeros(3, S, dtype=torch.int32),
             "segment_ids": torch.zeros(3, S, dtype=torch.int32),
             "positions": torch.zeros(3, S, dtype=torch.int32)}
    for b, x in enumerate(ids):
        batch["tokens"][b, :len(x)] = torch.from_numpy(x)
        batch["segment_ids"][b, :len(x)] = 1
        batch["positions"][b, :len(x)] = torch.arange(len(x))
    layout = PagedCacheLayout(num_pages=12, page_size=16, n_kv_heads=cfg["num_key_value_heads"],
                              head_dim=16, max_pages_per_seq=4)
    cache = model.init_paged_cache(layout, torch.float32)
    logits, cache = model.prefill(to_port(w, model), batch, cache)
    assert torch.allclose(logits[:, :cfg["vocab_size"]], ref, rtol=1e-5, atol=1e-5)
    pages = first_fit_pages(lengths, 16)
    assert [cache["alloc"].seq_pages(b) for b in range(3)] == pages
    slots = torch.cat([torch.tensor(p)[torch.arange(n) // 16] * 16 + torch.arange(n) % 16
                       for p, n in zip(pages, lengths)])
    for l, (k, v) in kv.items():
        assert torch.allclose(cache["k"][l].flatten(0, 1)[slots], k, rtol=1e-5, atol=1e-5)
        assert torch.allclose(cache["v"][l].flatten(0, 1)[slots], v, rtol=1e-5, atol=1e-5)


def test_the_packer_matches_the_ports_pipeline():
    from repro_torch.data import StreamingPipeline

    cfg = smoke_config("olmo-1b")
    pipe = StreamingPipeline(traffic.documents(LAW, cfg["vocab_size"], 8), seq_len=128,
                             batch_size=2, prefetch=0)
    for got, want in zip(itertools.islice(pipe, 40), _rows(cfg, 8, 40)):
        for k in want:
            assert np.array_equal(getattr(got, k), want[k]), k


def test_from_port_inverts_to_port():
    cfg = smoke_config("qwen3-8b")
    w = draw(cfg, 1, torch.float32, torch.device("cpu"))
    back = from_port(to_port(w, _model(cfg)))
    assert set(back) == set(w)
    for k in w:
        want = w[k] - 1 if k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm") else w[k]
        got = back[k][:w[k].shape[0]] if k in ("embed", "lm_head") else back[k]
        assert torch.equal(got, want), k


def test_weights_come_from_the_seed():
    cfg = smoke_config("olmo-1b")
    a, b, c = (draw(cfg, s, torch.float32, torch.device("cpu")) for s in (3, 3, 2 ** 40))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert abs(float(a["w_up"].std()) - cfg["assumed"]["init_std"]) < 1e-3
