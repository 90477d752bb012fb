"""Thread-affinity annotation vocabulary for the live runtime.

PR 7 split the runtime across a real OS-process boundary, which turned
two prose invariants into load-bearing facts:

- **loop-only** code runs exclusively on the master's asyncio event-loop
  thread.  Everything that mutates the master-side mirrors (``LivePE``
  state, ``Master``'s queues) must be loop-only — that is *why* the
  runtime needs no locks.
- **worker-side** code runs inside a worker OS process (or one of its PE
  threads).  It may block freely (``queue.Queue.get``, ``time.sleep``,
  the payload's ``run_sync``) but must never touch master-side state.

These decorators make the affinity machine-readable.  They are identity
decorators at runtime — zero overhead, no wrapping — but
``repro.analysis`` (the AST invariant checker) consumes them statically:

- rule R1 (blocking-in-async) exempts ``@worker_side`` bodies and
  ``@loop_only(blocking="reason")`` sections from the no-blocking-calls
  scan, and flags loop-reachable code that calls into ``@worker_side``;
- rule R2 (affinity) requires every mirror/queue mutation and every
  data-channel read to sit in a ``@loop_only`` (or ``async def``)
  function, and forbids them inside ``@worker_side``.

``@loop_only`` takes an optional ``blocking=`` reason for the few
deliberate places where the loop thread *does* block — e.g. the
transport's kill path, whose synchronous data-channel tail-drain is
exactly what makes a worker kill race-free.  The reason string is
mandatory when the keyword is used (the checker rejects an empty one):
an annotated blocking section must say why freezing the loop is safe.

``@transition`` extends the vocabulary to the delivery protocol itself:
it declares which entity state machine (message / worker slot / PE) a
function advances, on which event, from which source states to which
destination.  Rule R7 extracts these declarations, verifies each against
AST evidence in the same function (a matching ``bus.emit`` literal or a
``PEState``/``WorkerState`` mirror assignment), assembles the per-entity
machines, and pins them in ``protocol_manifest.json`` — which the model
checker explores and rule R8 replays against recorded event logs.
"""

from __future__ import annotations

from typing import Callable, Optional, TypeVar, overload

__all__ = ["loop_only", "worker_side", "transition"]

F = TypeVar("F", bound=Callable)


@overload
def loop_only(fn: F) -> F: ...


@overload
def loop_only(*, blocking: str) -> Callable[[F], F]: ...


def loop_only(fn: Optional[F] = None, *, blocking: Optional[str] = None):
    """Mark a function as event-loop-thread-only.

    Bare ``@loop_only`` declares "this runs on the loop thread and never
    blocks it".  ``@loop_only(blocking="why it is safe")`` additionally
    declares a deliberate blocking section on the loop thread — the
    checker allows blocking primitives inside it but requires the reason.
    """

    def mark(f: F) -> F:
        f.__loop_only__ = True
        f.__loop_blocking_reason__ = blocking
        return f

    if fn is not None:
        return mark(fn)
    return mark


def worker_side(fn: F) -> F:
    """Mark a function as running inside a worker process / PE thread.

    Worker-side code may block (that thread *is* the worker's CPU) but
    must never mutate master-side mirrors or call ``@loop_only`` code.
    Nested ``def``s inherit the annotation — a thread target defined
    inside a ``@worker_side`` entry point is worker-side too.
    """
    fn.__worker_side__ = True
    return fn


def transition(
    entity: str,
    event: str,
    src: str,
    dst: str,
    *,
    failing: bool = False,
    scope: Optional[str] = None,
) -> Callable[[F], F]:
    """Declare a protocol state-machine transition this function performs.

    ``entity`` is ``"msg"``, ``"worker"``, or ``"pe"``; ``event`` is
    either a pinned observability event type (contains a dot, e.g.
    ``"msg.pulled"``) or an *internal* transition name without one (e.g.
    ``"ready"`` — a state change that produces no event, used by the
    trace-conformance replay as an ε-edge).  ``src`` lists the allowed
    source states, ``|``-separated; ``dst`` is the single destination.

    ``failing=True`` marks a failure edge: the replay treats the instance
    as dead afterwards (a failed worker slot is never rebooted, so any
    later event for it is a violation).  ``scope="worker"`` widens a PE
    transition to every PE owned by the event's worker (a worker kill
    stops all its PEs at once).

    Identity decorator, stackable; rule R7 cross-checks each declaration
    against AST evidence in the decorated function and fails on stale or
    missing declarations, so the stack next to the code *is* the
    committed protocol.
    """

    def mark(f: F) -> F:
        declared = list(getattr(f, "__protocol_transitions__", ()))
        declared.append(
            {
                "entity": entity,
                "event": event,
                "src": src.split("|"),
                "dst": dst,
                "failing": failing,
                "scope": scope,
            }
        )
        f.__protocol_transitions__ = declared
        return f

    return mark
