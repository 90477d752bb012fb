"""IRM decision audit: why each request landed in its bin.

The allocator captures, per packing run (flag-gated, pure reads — the
decision path is untouched), the policy, the per-bin free vector *before*
the run, and each item's size and assignment.  This module replays the
policy's semantics over that snapshot to derive the rejection reason for
every bin scanned before the winner — "why did first-fit skip bin 3" —
and emits the whole record as one ``irm.pack`` event.

The replay is a post-hoc explanation, not a second decision: free
capacity is decremented by the recorded assignments, so the explanation
is consistent with what the packer actually did even if the replay's
notion of "fits" drifted (it uses the same ``free + eps >= size`` test
the packers do).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

_EPS = 1e-9
#: Per-item cap on recorded rejections (keeps event size bounded at
#: fleet scale; the paper-scale scenarios never hit it).
MAX_REJECTIONS = 32


def _family(policy: str) -> str:
    if "best" in policy:
        return "best"
    if "worst" in policy:
        return "worst"
    if "next" in policy:
        return "next"
    if "first" in policy:
        return "first"
    return "other"


def _insufficient(free_row: Sequence[float], size: Sequence[float],
                  dims: Optional[Sequence[str]]) -> str:
    for d, (f, s) in enumerate(zip(free_row, size)):
        if f + _EPS < s:
            name = dims[d] if dims and d < len(dims) else f"dim{d}"
            return f"insufficient {name}: need {s:.4g}, free {f:.4g}"
    return "insufficient capacity"


def explain_rejections(
    policy: str,
    capacity: Sequence[float],
    free_before: Sequence[Sequence[float]],
    sizes: Sequence[Sequence[float]],
    assignments: Sequence[int],
    dims: Optional[Sequence[str]] = None,
) -> List[List[dict]]:
    """Per item, the bins rejected before its winning bin and why.

    ``free_before`` is the per-bin free vector at the start of the run;
    the replay opens new bins at full ``capacity`` as assignments demand
    and decrements free capacity item by item.
    """
    free: List[List[float]] = [list(map(float, row)) for row in free_before]
    cap = list(map(float, capacity))
    cursor = 0  # next-fit scan position
    out: List[List[dict]] = []
    for size, b in zip(sizes, assignments):
        b = int(b)
        size = list(map(float, size))
        while b >= len(free):
            free.append(list(cap))

        def fits(j: int) -> bool:
            return all(f + _EPS >= s for f, s in zip(free[j], size))

        fam = _family(policy)
        rej: List[dict] = []
        if fam == "first":
            scanned = range(b)
        elif fam in ("best", "worst"):
            scanned = [j for j in range(len(free)) if j != b]
        elif fam == "next":
            scanned = range(b)
        else:
            scanned = range(b)
        for j in scanned:
            if len(rej) >= MAX_REJECTIONS:
                rej.append({"bin": -1, "reason": "... (truncated)"})
                break
            if fam == "next" and j < cursor:
                reason = "behind the next-fit cursor"
            elif not fits(j):
                reason = _insufficient(free[j], size, dims)
            elif fam == "best":
                reason = f"fits, but looser residual than bin {b}"
            elif fam == "worst":
                reason = f"fits, but less free capacity than bin {b}"
            elif fam == "first":
                # first-fit never skips a fitting bin; if we get here the
                # replay's eps disagrees with the packer's — say so.
                reason = "fits in replay (eps boundary); packer rejected"
            else:
                reason = f"scored lower than bin {b} under {policy}"
            rej.append({"bin": j, "reason": reason})
        if fam == "next":
            cursor = b
        out.append(rej)
        for d in range(len(size)):
            free[b][d] -= size[d]
    return out


def emit_packing_audit(bus, policy: str, packing) -> None:
    """Emit one ``irm.pack`` event for a completed packing run.

    The single emit site for this event type, shared by the sim and live
    drivers.  No-op unless the bus is present, at level ``full``, and the
    step actually ran a packing.  Works with or without allocator audit
    capture (placements/free_before are empty without it).
    """
    if bus is None or packing is None or not bus.audit:
        return
    a = packing.audit
    placements: List[dict] = []
    free_before: List[List[float]] = []
    pol = policy
    if a is not None:
        pol = a["policy"]
        free_before = [[float(x) for x in row] for row in a["free_before"]]
        rejections = explain_rejections(
            a["policy"], a["capacity"], a["free_before"], a["sizes"],
            a["assignments"], dims=a.get("dims"),
        )
        for i, b in enumerate(a["assignments"]):
            placements.append({
                "req_id": a["req_ids"][i],
                "image": a["images"][i],
                "size": [float(s) for s in a["sizes"][i]],
                "bin": int(b),
                "rejections": rejections[i],
            })
    bus.emit(
        "irm.pack",
        policy=pol,
        requests=len(packing.placements),
        num_bins=int(packing.num_bins),
        target_workers=int(packing.target_workers),
        ideal_bins=int(packing.ideal_bins),
        placements=placements,
        free_before=free_before,
    )
