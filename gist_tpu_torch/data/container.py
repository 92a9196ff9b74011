"""Dataset container — the analog of the reference's namedtuple +
``g.ndata`` convention (cluster_gcn/utils.py:85: graph carries
feat/label/train_mask/val_mask/test_mask)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Dataset:
    name: str
    senders: np.ndarray        # (E,) int64 raw COO (unpadded, host side)
    receivers: np.ndarray      # (E,)
    features: np.ndarray       # (N, F) float32
    labels: np.ndarray         # (N,) int32
    train_mask: np.ndarray     # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    n_classes: int
    # multitask datasets (ppi): the full (N, C) multi-hot label matrix.
    # The reference trains these with sigmoid logits + BCE and evaluates
    # threshold-at-0 micro-F1 (cluster_gcn/utils.py:47-57, 104-120);
    # ``labels`` then holds the argmax single-label view for code paths
    # that need one.
    labels_multi: Optional[np.ndarray] = None

    @property
    def multitask(self) -> bool:
        return self.labels_multi is not None

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def in_feats(self) -> int:
        return self.features.shape[1]

    def normalize_features(self) -> "Dataset":
        """StandardScaler fit on train nodes, applied to all — the
        ``--normalize`` path (cluster_gcn.py:36-42)."""
        train = self.features[self.train_mask]
        mean = train.mean(axis=0)
        std = train.std(axis=0)
        std = np.where(std > 0, std, 1.0)
        self.features = ((self.features - mean) / std).astype(np.float32)
        return self

    def random_projection(self, n_components: int, seed: int = 0) -> "Dataset":
        """Gaussian random projection to densify/pad input features so
        the width divides num_subnet (train_ist.py:71-84)."""
        rng = np.random.default_rng(seed)
        d = self.features.shape[1]
        proj = rng.standard_normal((d, n_components)).astype(np.float32)
        proj /= np.sqrt(n_components)
        self.features = (self.features @ proj).astype(np.float32)
        return self

    def summary(self) -> str:
        return (f"{self.name}: {self.n_nodes} nodes, {self.n_edges} edges, "
                f"{self.in_feats} feats, {self.n_classes} classes, "
                f"train/val/test = {int(self.train_mask.sum())}/"
                f"{int(self.val_mask.sum())}/{int(self.test_mask.sum())}")
