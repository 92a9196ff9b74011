"""Round batch collection for the IST trainers
(``gist_tpu/train/ist_cluster.py:_RoundCollector``).  The shard_map
trainer ``train_ist_cluster`` waits for the distributed slice."""

from __future__ import annotations

from typing import List

from gist_tpu_torch.sampler import (ClusterBatch, ClusterSampler,
                                    bucket_size, unify_tile_buckets)


def _batches_to_device(batches: List[ClusterBatch],
                       device) -> List[ClusterBatch]:
    """A round's batches with their dedup layouts re-padded to one
    bucket, moved to ``device`` (the part of the JAX package's
    ``_stack_batches`` that a Python loop over batches still needs)."""
    return [b.to(device) for b in unify_tile_buckets(batches)]


class _RoundCollector:
    """Pulls batches off the sampler epoch by epoch, padding each round
    to its max node and edge buckets.  ``ids_only=True`` ships node ids
    instead of per-batch feature tensors (pair with
    ``sampler.tables()``)."""

    def __init__(self, sampler: ClusterSampler, spr: int,
                 ids_only: bool = False):
        self.sampler = sampler
        self.spr = spr
        self.ids_only = ids_only
        self._gen = sampler.iter_node_ids()

    def collect(self) -> List[ClusterBatch]:
        id_sets = [next(self._gen) for _ in range(self.spr)]
        node_pad = max(bucket_size(len(ids)) for ids in id_sets)
        # extract each subgraph once, size the shared edge bucket
        edges = [self.sampler.csr_subgraph(ids) for ids in id_sets]
        edge_pad = max(bucket_size(max(len(s), 1)) for s, _ in edges)
        return [self.sampler.make_batch(ids, node_pad=node_pad,
                                        edge_pad=edge_pad, edges=e,
                                        ids_only=self.ids_only)
                for ids, e in zip(id_sets, edges)]
