"""The comparison that decides ``correct``: the program's readings of its
first steps against the reference's, each number beside its limit.

- ``loss``: the largest relative gap of a step's loss over the steps,
  and ``loss1`` the first step's alone (the later steps' losses follow
  Adam's first updates, which are nearly the signs of the gradients, and
  carry their rounding: ``PERF.md``);
- ``grad``: the first gradient's norm, by the worst leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change``: the same of the norm of the parameters' change over the
  steps, over the leaves that the reference's first gradient moves (a
  leaf whose gradient norm is under a thousandth of the median leaf's moves
  under Adam by rounding alone);
- ``nonfinite``: the window's steps whose loss is not finite."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

from harness.reference import Readings

MOVED = 1e-3     # a leaf moves when its gradient norm is at least this
                 # share of the median leaf's


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> float:
    leaves = sorted(ref if leaves is None else leaves)
    if not leaves or set(leaves) - set(prog):
        return math.inf
    med = statistics.median(ref[n] for n in leaves)
    gap = 0.0
    for n in leaves:
        g = abs(prog[n] - ref[n]) / max(ref[n], med)
        gap = max(gap, g if math.isfinite(g) else math.inf)
    return gap


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    losses = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    if len(prog.losses) != len(ref.losses):
        losses.append(math.inf)
    med = statistics.median(ref.grad_norms.values())
    moved = [n for n, g in ref.grad_norms.items() if g >= MOVED * med]
    return {
        "loss": max((x if math.isfinite(x) else math.inf) for x in losses),
        "loss1": losses[0] if math.isfinite(losses[0]) else math.inf,
        "grad": worst_leaf(prog.grad_norms, ref.grad_norms),
        "change": worst_leaf(prog.change_norms, ref.change_norms, moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit. A number the cell gives no limit is reported and not judged;
    a limited number that is missing fails."""
    out = {n: {"value": numbers.get(n, math.inf), "limit": lim}
           for n, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return {"correct": ok, "checks": out}
