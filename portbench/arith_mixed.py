"""The mixture's arithmetic: float operations of P policies mixed per agent,
from the layers' shapes of one actor-critic (`arith.forward_flops`: the
dense products of the model as the reference defines it, its neighbour
attention's first score layer in the cat form).

A row served is one agent-step judged under its own policy: the
mixture's nominal work.  The program's stacked forward computes every
head on every row (P rows computed a row served); the heads computed and
thrown away are the cost of dense routing, not work, and a share of the
peak counts only the rows served.
"""
from __future__ import annotations

from portbench.arith import forward_flops


def served_flops_per_row(flags: dict) -> int:
    """Float operations of one agent-step under its own policy."""
    return forward_flops(flags)
