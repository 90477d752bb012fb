"""Serving-backend adapter: drive scenario streams through the LLM engine.

The IRM control plane has two ``ClusterView``-style implementations: the
discrete-event cluster sim (``core/sim.py``) and the continuous-batching
serving engine (``serving/engine.py``).  This module maps a scenario's
``Stream`` onto the second one so the *same* registered workloads exercise
both backends:

  stream message  -> inference request (duration -> token counts)
  container image -> request class (the profiler key)
  batch arrival t -> request arrival time (optionally time-compressed)

The mapping is deliberately monotone — a message that runs 2x longer in the
cluster sim asks for 2x the decode tokens here — so a traffic shape keeps
its character (bursts stay bursts, heavy tails stay heavy) across backends.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..serving.engine import EngineConfig, ReplicaConfig, Request, ServingEngine
from .registry import Scenario, get_scenario
from .streams import Stream

__all__ = ["stream_to_requests", "run_serving_scenario", "default_engine_config"]


def default_engine_config(max_replicas: int = 5) -> EngineConfig:
    """The serving analogue of the paper's 5-worker SNIC cap."""
    return EngineConfig(
        replica=ReplicaConfig(
            max_slots=8, kv_pages=1024, page_size=16,
            prefill_tokens_per_s=80_000.0, decode_tokens_per_s=6_000.0,
            spinup_delay=5.0,
        ),
        max_replicas=max_replicas,
        dt=0.1,
    )


def stream_to_requests(
    stream: Stream,
    *,
    prompt_tokens_per_s: float = 60.0,
    decode_tokens_per_s: float = 16.0,
    min_prompt: int = 32,
    min_new_tokens: int = 16,
    time_scale: float = 1.0,
    mem_prompt_weight: float = 2.0,
    accel_decode_weight: float = 2.0,
) -> List[Tuple[float, Request]]:
    """Convert a workload stream into a time-ordered request schedule.

    A message of ``duration`` seconds becomes a request with prompt and
    decode lengths proportional to that duration, so per-class cost
    heterogeneity survives the translation.  ``time_scale`` compresses the
    arrival axis (the serving engine processes a "10 s" request in well
    under a second of engine time).

    Multi-resource messages map onto the replica's own vector dimensions:
    memory demand scales the *prompt* (KV pages are the serving engine's
    memory dimension), accelerator demand scales the *decode* length
    (slot-seconds are its accelerator-time dimension).  A message with no
    ``resources`` maps exactly as before.
    """
    schedule: List[Tuple[float, Request]] = []
    for t, msgs in sorted(stream.batches, key=lambda b: b[0]):
        for m in msgs:
            prompt_s = m.duration * prompt_tokens_per_s
            decode_s = m.duration * decode_tokens_per_s
            if m.resources:
                prompt_s *= 1.0 + mem_prompt_weight * m.resources.get("mem", 0.0)
                decode_s *= 1.0 + accel_decode_weight * m.resources.get("accel", 0.0)
            schedule.append(
                (
                    t * time_scale,
                    Request(
                        prompt_len=max(min_prompt, int(prompt_s)),
                        max_new_tokens=max(min_new_tokens, int(decode_s)),
                        req_class=m.image,
                    ),
                )
            )
    schedule.sort(key=lambda x: x[0])
    return schedule


def run_serving_scenario(
    scenario: Union[str, Scenario],
    *,
    seed: int = 0,
    stream_overrides: Optional[Dict[str, object]] = None,
    engine_cfg: Optional[EngineConfig] = None,
    time_scale: float = 0.25,
    t_max: float = 1200.0,
    request_kwargs: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Run one scenario's stream through the simulated serving backend.

    ``request_kwargs`` is forwarded to ``stream_to_requests`` (token-count
    mapping knobs).  Returns the engine summary extended with queue/replica
    statistics; the engine itself is included under ``"engine"`` for
    callers that want the raw per-tick metrics.
    """
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    stream = scn.make_stream(seed, **(stream_overrides or {}))
    schedule = stream_to_requests(
        stream, time_scale=time_scale, **(request_kwargs or {})
    )
    eng = ServingEngine(engine_cfg or default_engine_config())

    idx = 0
    while eng.t < t_max:
        while idx < len(schedule) and schedule[idx][0] <= eng.t:
            eng.submit(schedule[idx][1])
            idx += 1
        eng.step()
        if idx >= len(schedule) and not eng.queue and all(
            not r.active and not r.prefilling
            for r in eng.backend.replicas
            if not r.retired
        ):
            break

    replicas = np.array([m["replicas"] for m in eng.metrics]) if eng.metrics else np.array([1])
    queue = np.array([m["queue"] for m in eng.metrics]) if eng.metrics else np.array([0])
    summary: Dict[str, object] = dict(eng.summary())
    summary.update(
        {
            "scenario": scn.name,
            "backend": "serving",
            "submitted": len(schedule),
            "peak_replicas": int(replicas.max()),
            "final_replicas": int(replicas[-1]),
            "peak_queue_len": int(queue.max()),
            "engine": eng,
        }
    )
    return summary
