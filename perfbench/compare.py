"""The comparison that decides `correct`: the numbers compared between the
timed path's outputs and the plain reference's, each against its limit."""

from __future__ import annotations

import statistics


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b)


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                   leaves=None) -> tuple[float, str]:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and of the
    median leaf; -> (gap, leaf). `leaves` limits the leaves compared."""
    names = sorted(ref) if leaves is None else sorted(leaves)
    median = statistics.median(ref[n] for n in ref)
    gaps = [(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30), n) for n in names]
    return max(gaps)


def moved_leaves(ref_grad: dict[str, float], share: float = 1e-3) -> list[str]:
    """Leaves whose first gradient in the reference is at least `share` of
    the median leaf's: the others (a key's bias under softmax, ...) move
    under Adam by round-off alone and are left out of the change."""
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= share * median]


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """-> (every reading within its limit, {name: {"value", "limit"}})."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"no reading for {missing}")
    table = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
