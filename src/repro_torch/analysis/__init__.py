"""``repro_torch.analysis`` — the protocol checker for the port's runtime.

Rules R7 (the master-worker delivery protocol extracted from the runtime's
ASTs, drift-checked against ``protocol/protocol_manifest.json`` and
model-checked over every bounded interleaving with a worker kill) and R8
(recorded ``events.jsonl`` logs replayed against the same machines), over
``src/repro_torch/``: see ``protocol/``.  Run it with ``python -m
repro_torch.analysis.protocol``; ``python -m repro_torch.obs conformance``
replays one log.  Stdlib only: it parses the tree, it never imports it.

Rules R1-R6 (concurrency, the frozen reference, the wire contract,
determinism, the event schema) stay with ``python -m repro.analysis``,
which parses all of ``src/``, the port's files included.
"""
