"""The reference's Cluster-GCN batches: each batch's nodes worked out
again from the cached partition and the run's seed, and its induced
edges from the raw graph.  numpy and plain PyTorch."""

from __future__ import annotations

import math

import numpy as np
import torch


def bucket_size(n: int, growth: float = 1.2, min_size: int = 256) -> int:
    """The padded size of ``n``: the smallest ``min_size * growth^k`` at
    or above it."""
    if n <= min_size:
        return min_size
    k = math.ceil(math.log(n / min_size) / math.log(growth))
    return int(math.ceil(min_size * growth ** k))


def check_partition(parts: list, n_train: int) -> int:
    """Train nodes that the clusters miss or hold twice (0 for a
    partition)."""
    counts = np.bincount(np.concatenate(parts), minlength=n_train)
    return int((counts != 1).sum())


class BatchStream:
    """The node ids (train-local) of every batch of the endless stream:
    ``len(parts) // batch_size`` batches an epoch, the cluster order
    shuffled once at the start and again after every epoch by one numpy
    generator seeded with the run's sampler seed."""

    def __init__(self, parts: list, batch_size: int, seed: int):
        self.parts = parts
        self.batch_size = batch_size
        self.per_epoch = len(parts) // batch_size
        self.rng = np.random.default_rng(seed)
        self.order = np.arange(len(parts))
        self.rng.shuffle(self.order)
        self.epochs = []

    def node_ids(self, j: int) -> np.ndarray:
        """Batch ``j``'s node ids."""
        epoch, i = divmod(j, self.per_epoch)
        while len(self.epochs) <= epoch:
            self.epochs.append(self.order.copy())
            self.rng.shuffle(self.order)
        b = self.batch_size
        return np.concatenate([self.parts[k] for k in
                               self.epochs[epoch][i * b:(i + 1) * b]])


class TrainGraph:
    """The edges among train nodes, in train-local ids, on ``device``."""

    def __init__(self, arrays: dict, device):
        mask = arrays["train_mask"]
        self.train_nid = np.nonzero(mask)[0]
        self.n_train = len(self.train_nid)
        self.device = device
        mapping = torch.full((len(mask),), -1, dtype=torch.int64,
                             device=device)
        mapping[torch.from_numpy(self.train_nid).to(device)] = torch.arange(
            self.n_train, device=device)
        s = mapping[torch.from_numpy(arrays["senders"]).to(device)]
        r = mapping[torch.from_numpy(arrays["receivers"]).to(device)]
        keep = (s >= 0) & (r >= 0)
        self.src, self.dst = s[keep], r[keep]
        del s, r, keep, mapping

    def induced(self, ids: np.ndarray) -> tuple:
        """(src, dst) of the edges among ``ids``, as positions in ``ids``."""
        pos = torch.full((self.n_train,), -1, dtype=torch.int64,
                         device=self.device)
        pos[torch.from_numpy(ids).to(self.device)] = torch.arange(
            len(ids), device=self.device)
        ps, pr = pos[self.src], pos[self.dst]
        keep = (ps >= 0) & (pr >= 0)
        return ps[keep], pr[keep]


def same_edges(src_a, dst_a, src_b, dst_b, n: int) -> bool:
    """Whether two edge lists over ``n`` nodes hold the same edges, each
    as many times."""
    if src_a.numel() != src_b.numel():
        return False
    ka = torch.sort(dst_a.long() * n + src_a.long()).values
    kb = torch.sort(dst_b.long().to(ka.device) * n
                    + src_b.long().to(ka.device)).values
    return bool(torch.equal(ka, kb))
