"""The reference's side of the check: recompute from the benchmark's inputs
(the seed's documents, prompts and weights) what the timed path had to
produce, and measure how far the program's outputs lie from it.

Training outputs are a dict: ``rows`` (the batches the pipeline emitted, as
dicts of (rows, seq) arrays), ``losses`` (the first steps' losses),
``grad`` and ``change`` ({(leaf, layer): norm}: the first step's gradient
before clipping, and the weights' change over the first steps).  Prefill
outputs are a list of batches, each a dict: ``ids`` (one prompt a
request), ``pages`` (the pages the request's K/V went to), ``logits``
((requests, >= V) last-token logits), ``tokens`` (the served first tokens)
and ``kv(layer)`` (that layer's K and V of the prompts' tokens, in order,
(tokens, KVH, hd) each, read where First-Fit puts them).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import traffic as traffic_gen
from ..weights import draw
from .model import Precision, Tokens, adamw_step, exact_fp32, prefill, train_loss
from .packer import packed_rows

__all__ = ["STACKED", "leaf_norms", "tokens_of_rows", "train_outputs", "train_numbers",
           "first_fit_pages", "slots_of", "prefill_outputs", "prefill_numbers"]

STACKED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1", "ln2", "q_norm", "k_norm")
# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone and is left out of the gradient and change gaps
ROUNDING_SHARE = 1e-3
_ROW_KEYS = ("tokens", "labels", "segment_ids", "positions")


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[Tuple[str, int], float]:
    """Norm of each leaf, each layer of a stacked leaf apart."""
    keys, vals = [], []
    for name in sorted(tree):
        t = tree[name].detach().float()
        if name in STACKED:
            keys += [(name, l) for l in range(t.shape[0])]
            vals.append(t.flatten(1).norm(dim=1))
        else:
            keys.append((name, -1))
            vals.append(t.norm().view(1))
    return dict(zip(keys, torch.cat(vals).tolist()))


def tokens_of_rows(batch: Dict[str, np.ndarray], device) -> Tuple[Tokens, torch.Tensor]:
    """A packed batch's documents (each row's runs of one segment id) and
    their labels, in row order."""
    docs, labels = [], []
    for b in range(batch["segment_ids"].shape[0]):
        seg = batch["segment_ids"][b]
        for s in np.unique(seg[seg > 0]):
            at = np.flatnonzero(seg == s)
            docs.append(batch["tokens"][b, at])
            labels.append(batch["labels"][b, at])
    tok = Tokens.from_documents(docs, device)
    return tok, torch.from_numpy(np.concatenate(labels)).long().to(device)


def train_outputs(cfg: Dict, traffic: Dict, seed: int, n_rows: int, device,
                  prec: Precision) -> Dict:
    """The reference's (or, at fp8, the control's) rows and first steps,
    from the seed's documents and weights."""
    docs = traffic_gen.documents(traffic["documents"], cfg["vocab_size"], seed)
    rows = list(itertools.islice(packed_rows(docs, traffic["seq_len"], cfg["train_rows_per_step"]),
                                 n_rows))
    opt = cfg["optimizer"]
    with exact_fp32():
        params = draw(cfg, seed, torch.float32, device)
        start = {n: p.clone() for n, p in params.items()}
        for p in params.values():
            p.requires_grad_(True)
        state, losses, grad = {}, [], None
        for step in range(1, traffic["check_steps"] + 1):
            tok, labels = tokens_of_rows(rows[step - 1], device)
            loss = train_loss(cfg, params, tok, labels, prec, z_loss=cfg["loss"]["z_loss"])
            names = sorted(params)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            losses.append(float(loss.detach()))
            if grad is None:
                grad = leaf_norms(grads)
            with torch.no_grad():
                adamw_step(opt, params, grads, state, step)
            del grads, loss
        change = leaf_norms({n: params[n].detach() - start[n] for n in params})
    return {"rows": rows, "losses": losses, "grad": grad, "change": change}


def _worst_gap(prog: Dict, ref: Dict, keep: List) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    rows_bad = sum(any(not np.array_equal(p[k], r[k]) for k in _ROW_KEYS)
                   for p, r in zip(prog["rows"], ref["rows"]))
    rows_bad += abs(len(prog["rows"]) - len(ref["rows"]))
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, g in ref["grad"].items() if g >= ROUNDING_SHARE * med]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    return {"rows_mismatched": float(rows_bad), "loss_gap": loss,
            "grad_gap": _worst_gap(prog["grad"], ref["grad"], keep),
            "change_gap": _worst_gap(prog["change"], ref["change"], keep)}


def first_fit_pages(lengths: List[int], page_size: int) -> List[List[int]]:
    """The pages First-Fit gives each request on an empty pool, in order."""
    out, at = [], 0
    for n in lengths:
        p = -(-n // page_size)
        out.append(list(range(at, at + p)))
        at += p
    return out


def slots_of(pages: List[List[int]], lengths: List[int], page_size: int, device) -> torch.Tensor:
    """The flat pool slots of the requests' tokens, in order."""
    slots = [np.asarray(pg, dtype=np.int64)[np.arange(n) // page_size] * page_size
             + np.arange(n) % page_size for pg, n in zip(pages, lengths)]
    return torch.from_numpy(np.concatenate(slots)).to(device)


def prefill_outputs(cfg: Dict, ids: List[List[np.ndarray]], seed: int, device,
                    prec: Precision) -> List[Dict]:
    """The control's outputs: the reference at ``prec`` in the program's
    place, its K/V kept as its cache would keep them."""
    weights = draw(cfg, seed, torch.bfloat16, device)
    out = []
    with exact_fp32():
        for batch_ids in ids:
            tok = Tokens.from_documents(batch_ids, device)
            kept: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
            logits = prefill(cfg, weights, tok, prec, lambda l, k, v: kept.__setitem__(l, (k, v)))
            lengths = [len(x) for x in batch_ids]
            out.append({"ids": batch_ids, "pages": first_fit_pages(lengths, cfg["page_size"]),
                        "logits": logits.cpu(), "tokens": logits.argmax(-1).cpu().numpy(),
                        "kv": lambda l, kept=kept: kept[l]})
    return out


def prefill_numbers(cfg: Dict, prog: List[Dict], seed: int, device) -> Dict[str, float]:
    """Run the reference over each kept batch's prompts, layer by layer, and
    hold the program's page table, K/V, logits and served tokens to it.

    ``kv_gap`` is the widest gap of one token's K (or V) in one layer: the
    norm of the difference over the layer's root-mean-square token norm, so
    that a single token written wrong shows whole."""
    weights = draw(cfg, seed, torch.bfloat16, device)
    ps, V = cfg["page_size"], cfg["vocab_size"]
    pages_bad, kv_gap, logit_gap, token_gap = 0, 0.0, 0.0, 0.0
    with exact_fp32():
        for batch in prog:
            lengths = [len(x) for x in batch["ids"]]
            pages = first_fit_pages(lengths, ps)
            pages_bad += sum(list(p) != q for p, q in zip(batch["pages"], pages))
            tok = Tokens.from_documents(batch["ids"], device)

            def on_kv(l, k, v):
                nonlocal kv_gap
                for got, want in zip(batch["kv"](l), (k, v)):
                    err = (got.float() - want).flatten(1).norm(dim=1)
                    rms = want.flatten(1).square().sum(1).mean().sqrt()
                    kv_gap = max(kv_gap, float(err.max() / rms))

            ref = prefill(cfg, weights, tok, Precision("fp32"), on_kv).cpu()
            got = batch["logits"][:, :V].float().cpu()
            logit_gap = max(logit_gap, float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max()))
            for r, t in zip(ref, batch["tokens"]):
                token_gap = max(token_gap, float(r.max() - r[t]) if t < V else math.inf)
    return {"page_table_mismatched": float(pages_bad), "kv_gap": kv_gap,
            "logits_gap": logit_gap, "token_gap": token_gap}
