"""Faults planted in the port's timed path, to show that the check catches
each fault a cell can have: the state a step returns left unchanged, half
of the batch left out (the mean taken over the rest), a token or an answer
altered where it is produced.  (Each cell runs on one card: no exchange
between cards to leave out.)  Each is a context manager that patches the
port in this process and restores it on exit."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

__all__ = ["FAULTS", "planted"]


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _train_state_unchanged():
    import torch
    from repro_torch.training import train_step

    def update(params, grads, state, cfg):
        one = torch.ones((), device=grads["embed"].device)
        return params, state, {"grad_norm": one, "lr": one}
    return _patched(train_step, "adamw_update", update)


def _train_half_batch():
    from repro_torch.models.transformer import DecoderLM
    loss = DecoderLM.loss

    def half(self, params, batch, **kw):
        return loss(self, params, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, **kw)
    return _patched(DecoderLM, "loss", half)


def _train_token_altered():
    from repro_torch.data.packing import SequencePacker
    emit = SequencePacker._emit

    def altered(self, rows):
        out = emit(self, rows)
        out.tokens[0, 0] += 1
        return out
    return _patched(SequencePacker, "_emit", altered)


def _prefill_state_unchanged():
    from repro_torch.models import transformer
    return _patched(transformer, "write_tokens", lambda *args: None)


def _prefill_half_batch():
    from repro_torch.models.transformer import DecoderLM
    prefill = DecoderLM.prefill

    def half(self, params, batch, cache):
        B = batch["tokens"].shape[0]
        rows = {k: v[:(B + 1) // 2] for k, v in batch.items()}
        logits, cache = prefill(self, params, rows, cache)
        return logits.repeat(2, 1)[:B], cache
    return _patched(DecoderLM, "prefill", half)


def _prefill_token_altered():
    from repro_torch.launch import serve
    greedy = serve.greedy
    return _patched(serve, "greedy", lambda logits: greedy(logits) + 1)


FAULTS: Dict[str, Dict] = {
    "packed_train": {"state_unchanged": _train_state_unchanged,
                     "half_batch": _train_half_batch,
                     "token_altered": _train_token_altered},
    "batched_prefill": {"state_unchanged": _prefill_state_unchanged,
                        "half_batch": _prefill_half_batch,
                        "token_altered": _prefill_token_altered},
}


def planted(kind: str, fault: str):
    """The fault ``fault`` of a ``kind`` cell, as a context manager."""
    return FAULTS[kind][fault]()
