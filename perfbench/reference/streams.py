"""What a run's ``--seed`` draws, and how: one place for the drivers and
the reference, so both sides take the same inputs.

The cluster order is the cell's data, with the graph and its partition:
the sampler's own stream (its ``seed``) at ``CLUSTER_ORDER_SEED``, the
same for every run, so that every seed trains the same batches: which
clusters share a batch sets its edges, so a seed that drew the order
drew the work too (on an H100 the GAT cell's rate read 20% apart
between seeds and 3% apart between two runs of one seed).  From
``--seed``:

* the IST boundaries: ``seed + 1`` (a numpy ``Generator`` on the host for
  the ultra-wide round, a CPU ``torch.Generator`` for the single-card
  round, as each trainer draws them);
* the dropout of round r: a seed drawn from a device ``torch.Generator``
  seeded ``seed + 2``, stream s of it for subnet s;
* the initial weights: a device ``torch.Generator`` seeded ``seed + 3``;
* the batches the check samples: ``np.random.default_rng(seed + 4)``.
"""

from __future__ import annotations

import torch

CLUSTER_ORDER_SEED = 0
BOUNDARIES, DROPOUT, WEIGHTS, CHECK = 1, 2, 3, 4


def stream(seed: int, which: int) -> int:
    """The seed of stream ``which`` of a run seeded ``seed``."""
    return seed + which


def fold_in(seed: int, index: int) -> int:
    """Stream ``index`` of ``seed``: the seed of subnet ``index``'s
    dropout generator in a round whose seed is ``seed`` (the program's
    ``utils.fold_in``, the definition of the dropout streams)."""
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
            + 1) % (1 << 63)


def round_seeds(seed: int, rounds: int, device) -> list:
    """The dropout seeds of the first ``rounds`` rounds: one 62-bit draw a
    round from the device generator of stream ``DROPOUT`` (the program's
    ``utils.draw_seed``)."""
    g = torch.Generator(device=device).manual_seed(stream(seed, DROPOUT))
    return [int(torch.randint(0, 1 << 62, (1,), generator=g,
                              device=g.device).item())
            for _ in range(rounds)]
