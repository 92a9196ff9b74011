"""IST boundary sizes and the padding id of non-divisible partitions."""

from __future__ import annotations

from typing import List, Optional

# Padding id for non-divisible partitions: gathers read it as zero,
# scatters drop it.  Large enough that the SAGE doubled index
# (idx + in_dim) stays out of bounds too.
VIRTUAL_IDX = 1 << 30


def boundary_sizes(in_feats: int, n_hidden: int, n_layers: int,
                   *, split_input: bool,
                   split_output: bool) -> List[Optional[int]]:
    """Sizes of each partitioned boundary of a SAGE stack of
    ``n_layers + 1`` weight layers; boundary b feeds weight-layer b's
    input.  ``None`` marks an unsplit boundary."""
    sizes: List[Optional[int]] = [in_feats if split_input else None]
    for _ in range(1, n_layers):
        sizes.append(n_hidden)
    sizes.append(n_hidden if split_output else None)
    return sizes
