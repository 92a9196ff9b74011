"""IST boundary partitions (``gist_tpu/ist/partition.py``): sizes,
random disjoint splits drawn from a ``torch.Generator``, and the padding
id of non-divisible partitions.  ``jax.random`` and torch give different
splits from one seed; the parity tests inject the JAX ones."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# Padding id for non-divisible partitions: gathers read it as zero,
# scatters drop it.  Large enough that the SAGE doubled index
# (idx + in_dim) stays out of bounds too.
VIRTUAL_IDX = 1 << 30


def sample_partition(generator: torch.Generator, dim: int,
                     num_subnet: int) -> torch.Tensor:
    """(num_subnet, ceil(dim / num_subnet)) int64 on the generator's
    device: row s is subnet s's disjoint index set, together covering
    range(dim); non-divisible dims pad with VIRTUAL_IDX entries."""
    c = -(-dim // num_subnet)
    perm = torch.randperm(num_subnet * c, generator=generator,
                          device=generator.device)
    if num_subnet * c != dim:
        perm = torch.where(perm < dim, perm, VIRTUAL_IDX)
    return perm.reshape(num_subnet, c)


def sample_boundaries(generator: torch.Generator,
                      sizes: List[Optional[int]],
                      num_subnet: int) -> Tuple[Optional[torch.Tensor], ...]:
    """A partition per boundary, drawn in order from ``generator``;
    ``None`` sizes stay ``None``."""
    return tuple(None if size is None
                 else sample_partition(generator, size, num_subnet)
                 for size in sizes)


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
