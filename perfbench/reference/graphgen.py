"""The benchmark's graph generator: a frozen copy of the arithmetic of
``gist_tpu_torch/data/synthetic.py`` (a hierarchical stochastic block
model whose shape statistics mirror the GIST papers' datasets), so that a
change to the program cannot change the cells' data.  It returns the
arrays; :mod:`perfbench.data` caches them and builds the program's
``Dataset`` from them.  numpy only.
"""

from __future__ import annotations

import zlib

import numpy as np

# name -> (n_nodes, avg_degree, n_feats, n_classes, n_train, n_val, n_test)
SYNTH_SPECS = {
    "synth-cora":     (2708, 4, 1432, 7, 140, 500, 1000),
    "synth-citeseer": (3327, 3, 3702, 6, 120, 500, 1000),
    "synth-pubmed":   (19717, 3, 500, 3, 60, 500, 1000),
    "synth-reddit-small": (23000, 50, 602, 41, 15000, 4000, 4000),
    "synth-reddit":   (232965, 100, 602, 41, 153431, 23831, 55703),
    # real Reddit's edge count (114.6M directed; edges here are
    # symmetrized, E = 2*n*deg + n) — the >HBM full-graph GAT target
    "synth-reddit-full": (232965, 246, 602, 41, 153431, 23831, 55703),
    "synth-amazon2m-small": (120000, 25, 100, 47, 100000, 10000, 10000),
    "synth-amazon2m": (2449029, 25, 100, 47, 1709124, 739905, 0),
    "synth-tiny":     (256, 4, 32, 4, 64, 64, 64),
}

# Hardness knobs (shared across specs; the program's module docstring
# gives their reasons).
COMM_SIZE = 160        # nodes per community (~ METIS cluster scale)
CLASS_PURITY = 0.65    # fraction of a community in its dominant class
P_COMM = 0.55          # edge endpoint drawn from own community
P_CLASS = 0.15         # ... from own class anywhere
FEAT_SCALE = 0.32      # class-center strength in features
LABEL_NOISE = 0.10     # fraction of labels resampled uniformly


def generate(name: str, seed: int = 0) -> dict:
    """The arrays of synthetic graph ``name`` drawn from ``seed``."""
    if name not in SYNTH_SPECS:
        raise KeyError(f"unknown synthetic dataset {name!r}; "
                       f"known: {sorted(SYNTH_SPECS)}")
    n, avg_deg, n_feats, n_classes, n_train, n_val, n_test = SYNTH_SPECS[name]
    # zlib.crc32 is stable across processes (Python's str hash is salted
    # per interpreter, which made "deterministic" datasets vary by run).
    rng = np.random.default_rng(seed ^ (zlib.crc32(name.encode()) & 0xFFFF))

    # --- communities with a dominant class ---------------------------------
    n_comm = max(1, n // COMM_SIZE)
    comm = rng.integers(0, n_comm, size=n).astype(np.int64)
    comm_class = rng.integers(0, n_classes, size=n_comm).astype(np.int32)
    labels = np.where(rng.random(n) < CLASS_PURITY, comm_class[comm],
                      rng.integers(0, n_classes, size=n)).astype(np.int32)

    # true labels drive structure/features; observed labels get noise later
    true_labels = labels.copy()

    # --- edges: community / class / uniform mixture ------------------------
    deg = np.maximum(rng.poisson(avg_deg, size=n), 1)
    e_src = np.repeat(np.arange(n, dtype=np.int64), deg)
    n_e = e_src.shape[0]
    u = rng.random(n_e)

    # same-community targets via per-community pools
    comm_order = np.argsort(comm, kind="stable")
    comm_starts = np.searchsorted(comm[comm_order], np.arange(n_comm))
    comm_ends = np.searchsorted(comm[comm_order], np.arange(n_comm), "right")
    src_comm = comm[e_src]
    lo, hi = comm_starts[src_comm], comm_ends[src_comm]
    comm_tgt = comm_order[lo + (rng.random(n_e) * np.maximum(hi - lo, 1)
                                ).astype(np.int64)]

    # same-class targets via per-class pools
    cls_order = np.argsort(true_labels, kind="stable")
    cls_starts = np.searchsorted(true_labels[cls_order], np.arange(n_classes))
    cls_ends = np.searchsorted(true_labels[cls_order], np.arange(n_classes),
                               "right")
    src_lbl = true_labels[e_src]
    clo, chi = cls_starts[src_lbl], cls_ends[src_lbl]
    cls_tgt = cls_order[clo + (rng.random(n_e) * np.maximum(chi - clo, 1)
                               ).astype(np.int64)]

    rand_tgt = rng.integers(0, n, size=n_e)
    e_dst = np.where(u < P_COMM, comm_tgt,
                     np.where(u < P_COMM + P_CLASS, cls_tgt, rand_tgt))

    # symmetrize + self loops (matching reference preprocessing)
    senders = np.concatenate([e_src, e_dst, np.arange(n, dtype=np.int64)])
    receivers = np.concatenate([e_dst, e_src, np.arange(n, dtype=np.int64)])

    # --- class-correlated sparse-ish features ------------------------------
    centers = rng.standard_normal((n_classes, n_feats)).astype(np.float32)
    feats = (FEAT_SCALE * centers[true_labels]
             + rng.standard_normal((n, n_feats)).astype(np.float32))
    # sparsify like bag-of-words inputs (cora features are 0/1 sparse)
    mask = rng.random((n, n_feats)) < min(1.0, 50.0 / n_feats)
    feats = np.where(mask, feats, 0.0).astype(np.float32)

    # --- observed labels: irreducible noise floor --------------------------
    flip = rng.random(n) < LABEL_NOISE
    labels = np.where(flip, rng.integers(0, n_classes, size=n),
                      true_labels).astype(np.int32)

    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train:n_train + n_val]] = True
    if n_test > 0:
        test_mask[perm[n_train + n_val:n_train + n_val + n_test]] = True
    else:
        test_mask[perm[n_train + n_val:]] = True

    return {"senders": senders, "receivers": receivers, "features": feats,
            "labels": labels, "train_mask": train_mask, "val_mask": val_mask,
            "test_mask": test_mask, "n_classes": n_classes}
