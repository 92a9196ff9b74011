"""On-disk dataset loaders and the dataset dispatch
(``gist_tpu/data/loaders.py``), in numpy: the arrays equal the JAX
package's for the same files.

``load_dataset`` resolves, in order:
  1. ``synth-*`` names -> deterministic synthetic graphs (no disk).
  2. planetoid names (cora/citeseer/pubmed) -> the ``ind.<name>.*``
     pickle files under ``root``.
  3. ``reddit`` / ``reddit-self-loop`` -> DGL-format ``reddit_data.npz``
     and ``reddit_graph.npz`` under ``root``.
  4. ``amazon2m`` -> GraphSAGE-format ``<prefix>-{G.json,feats.npy,
     id_map.json,class_map.json}``; the parsed graph is cached as
     ``<prefix>-processed.npz`` beside them, the same file with the
     same keys as the JAX package's cache, so either package reads a
     cache the other wrote.
  5. ``ppi`` -> the GraphSAGE-format ``ppi/`` splits batched into one
     graph, with the multi-hot labels in ``labels_multi``.
Missing files raise FileNotFoundError naming the expected paths; no
synthetic graph is substituted (callers opt into ``synth-*``).
"""

from __future__ import annotations

import json
import os
import pickle
import sys
from typing import Optional

import numpy as np

from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.data.synthetic import SYNTH_SPECS, synthetic_dataset

PLANETOID = ("cora", "citeseer", "pubmed")


def load_dataset(name: str, root: Optional[str] = None, *,
                 self_loop: bool = False, seed: int = 0) -> Dataset:
    if name in SYNTH_SPECS:
        ds = synthetic_dataset(name, seed=seed)
    elif name in PLANETOID:
        ds = load_planetoid(name, root or "./data")
    elif name in ("reddit", "reddit-self-loop"):
        ds = load_reddit(root or "./data",
                         self_loop=(name == "reddit-self-loop"))
    elif name == "amazon2m":
        ds = load_amazon2m(root or "./data")
    elif name == "ppi":
        ds = load_ppi(root or "./data")
    else:
        raise KeyError(f"unknown dataset {name!r}")
    if self_loop:
        ds = _add_self_loops(ds)
    return ds


def _add_self_loops(ds: Dataset) -> Dataset:
    from gist_tpu_torch.graph import add_self_loops
    s, r = add_self_loops(ds.senders, ds.receivers, ds.n_nodes)
    ds.senders, ds.receivers = s, r
    return ds


# ---------------------------------------------------------------------------
# Planetoid (cora / citeseer / pubmed) — the ind.<name>.* pickle format
# ---------------------------------------------------------------------------

def _load_pickle(path):
    with open(path, "rb") as f:
        if sys.version_info.major >= 3:
            return pickle.load(f, encoding="latin1")
        return pickle.load(f)


def load_planetoid(name: str, root: str) -> Dataset:
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    paths = [os.path.join(root, f"ind.{name}.{n}") for n in names]
    test_idx_path = os.path.join(root, f"ind.{name}.test.index")
    missing = [p for p in paths + [test_idx_path] if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"planetoid files for {name!r} not found; missing: {missing}. "
            f"Use 'synth-{name}' for the synthetic stand-in.")
    x, y, tx, ty, allx, ally, graph = [_load_pickle(p) for p in paths]
    test_idx = np.loadtxt(test_idx_path, dtype=np.int64)
    test_range = np.sort(test_idx)

    def _dense(m):
        return np.asarray(m.todense()) if hasattr(m, "todense") else np.asarray(m)

    allx, tx = _dense(allx), _dense(tx)
    ally, ty = np.asarray(ally), np.asarray(ty)

    # citeseer has isolated test nodes: test.index is non-contiguous,
    # so tx/ty must be zero-extended over the full [min, max] test-id
    # span BEFORE the vstack (otherwise features[test_idx] below indexes
    # past the end).  Rows are placed at sorted positions; the reorder
    # after the vstack then moves them to file order — the standard
    # planetoid citeseer handling the reference inherits through DGL.
    span = int(test_range[-1]) - int(test_range[0]) + 1
    if span != len(test_idx):
        tx_ext = np.zeros((span, tx.shape[1]), tx.dtype)
        tx_ext[test_range - test_range[0]] = tx
        ty_ext = np.zeros((span, ty.shape[1]), ty.dtype)
        ty_ext[test_range - test_range[0]] = ty
        tx, ty = tx_ext, ty_ext

    features = np.vstack([allx, tx]).astype(np.float32)
    labels_oh = np.vstack([ally, ty])
    # move test rows from sorted to file order (tx row k is node
    # test_idx[k])
    features[test_idx] = features[test_range]
    labels_oh[test_idx] = labels_oh[test_range]
    labels = labels_oh.argmax(axis=1).astype(np.int32)

    n = features.shape[0]
    senders, receivers = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            senders.append(u)
            receivers.append(v)
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[:y.shape[0]] = True
    val_mask[y.shape[0]:y.shape[0] + 500] = True
    test_mask[test_idx] = True

    return Dataset(name=name, senders=senders, receivers=receivers,
                   features=features, labels=labels, train_mask=train_mask,
                   val_mask=val_mask, test_mask=test_mask,
                   n_classes=labels_oh.shape[1])


# ---------------------------------------------------------------------------
# Reddit — DGL npz format
# ---------------------------------------------------------------------------

def load_reddit(root: str, self_loop: bool = False) -> Dataset:
    data_p = os.path.join(root, "reddit_data.npz")
    graph_p = os.path.join(root, "reddit_graph.npz")
    for p in (data_p, graph_p):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found; use 'synth-reddit' for the synthetic "
                f"stand-in.")
    data = np.load(data_p)
    feats = data["feature"].astype(np.float32)
    labels = data["label"].astype(np.int32)
    node_types = data["node_types"]
    import scipy.sparse as sp
    adj = sp.load_npz(graph_p).tocoo()
    senders = adj.row.astype(np.int64)
    receivers = adj.col.astype(np.int64)
    if self_loop:
        from gist_tpu_torch.graph import add_self_loops
        senders, receivers = add_self_loops(senders, receivers, feats.shape[0])
    return Dataset(
        name="reddit", senders=senders, receivers=receivers, features=feats,
        labels=labels, train_mask=node_types == 1, val_mask=node_types == 2,
        test_mask=node_types == 3, n_classes=41)


# ---------------------------------------------------------------------------
# PPI — GraphSAGE-format splits batched into one disjoint graph
# (cluster_gcn/utils.py:90-120: train/valid/test graphs concatenated
# with positional masks)
# ---------------------------------------------------------------------------

def load_ppi(root: str) -> Dataset:
    """Expects the standard ppi/ directory ({split}_graph.json,
    {split}_feats.npy, {split}_labels.npy) and batches the three splits
    into one graph with contiguous masks, like the reference."""
    splits = ("train", "valid", "test")
    missing = []
    for sp in splits:
        for suffix in ("_graph.json", "_feats.npy", "_labels.npy"):
            p = os.path.join(root, "ppi", sp + suffix)
            if not os.path.exists(p):
                missing.append(p)
    if missing:
        raise FileNotFoundError(
            f"ppi files not found; missing {missing[:3]}...")

    all_s, all_r, all_f, all_l = [], [], [], []
    counts = []
    offset = 0
    for sp in splits:
        base = os.path.join(root, "ppi", sp)
        with open(base + "_graph.json") as f:
            gj = json.load(f)
        feats = np.load(base + "_feats.npy").astype(np.float32)
        labels = np.load(base + "_labels.npy")
        n = feats.shape[0]
        links = gj["links"]
        s = np.fromiter((l["source"] for l in links), np.int64, len(links))
        r = np.fromiter((l["target"] for l in links), np.int64, len(links))
        all_s.append(s + offset)
        all_r.append(r + offset)
        all_f.append(feats)
        all_l.append(labels)
        counts.append(n)
        offset += n

    n_total = offset
    # PPI is multitask: keep the full (N, 121) multi-hot matrix so
    # training uses sigmoid BCE + threshold-at-0 micro-F1 like the
    # reference (utils.py:104-120); ``labels`` is the argmax view.
    labels_mat = np.concatenate(all_l)
    if labels_mat.ndim == 2:
        labels_multi = labels_mat.astype(np.float32)
        labels = labels_mat.argmax(axis=1).astype(np.int32)
        n_classes = labels_mat.shape[1]
    else:
        labels_multi = None
        labels = labels_mat.astype(np.int32)
        n_classes = int(labels.max()) + 1
    train_mask = np.zeros(n_total, bool)
    val_mask = np.zeros(n_total, bool)
    test_mask = np.zeros(n_total, bool)
    train_mask[:counts[0]] = True
    val_mask[counts[0]:counts[0] + counts[1]] = True
    test_mask[counts[0] + counts[1]:] = True
    return Dataset(
        name="ppi", senders=np.concatenate(all_s),
        receivers=np.concatenate(all_r),
        features=np.concatenate(all_f), labels=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        n_classes=n_classes, labels_multi=labels_multi)


# ---------------------------------------------------------------------------
# Amazon2M — GraphSAGE json/npy format (AmazonDataset.py:18-188)
# ---------------------------------------------------------------------------

def load_amazon2m(root: str, prefix: str = "amazon2M") -> Dataset:
    # processed-graph cache, the analog of AmazonDataset's dgl_graph.bin
    # (AmazonDataset.py:127-144) — parsing the 2M-node json is minutes
    cache = os.path.join(root, f"{prefix}-processed.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return Dataset(
            name="amazon2m", senders=z["senders"], receivers=z["receivers"],
            features=z["features"], labels=z["labels"],
            train_mask=z["train_mask"], val_mask=z["val_mask"],
            test_mask=z["test_mask"], n_classes=int(z["n_classes"]))
    g_p = os.path.join(root, f"{prefix}-G.json")
    f_p = os.path.join(root, f"{prefix}-feats.npy")
    id_p = os.path.join(root, f"{prefix}-id_map.json")
    cls_p = os.path.join(root, f"{prefix}-class_map.json")
    for p in (g_p, f_p, id_p, cls_p):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found; use 'synth-amazon2m' for the synthetic "
                f"stand-in.")
    feats = np.load(f_p).astype(np.float32)
    with open(id_p) as f:
        id_map = {k: int(v) for k, v in json.load(f).items()}
    with open(cls_p) as f:
        class_map = {k: int(v) for k, v in json.load(f).items()}
    with open(g_p) as f:
        g_json = json.load(f)

    n = feats.shape[0]
    labels = np.zeros(n, np.int32)
    for k, v in class_map.items():
        labels[id_map[k]] = v

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    for node in g_json["nodes"]:
        i = id_map[str(node["id"])]
        if node.get("test"):
            test_mask[i] = True
        elif node.get("val"):
            val_mask[i] = True
        else:
            train_mask[i] = True

    links = g_json["links"]
    senders = np.fromiter((l["source"] for l in links), np.int64, len(links))
    receivers = np.fromiter((l["target"] for l in links), np.int64, len(links))
    # symmetrize (AmazonDataset.py:94-100 builds a symmetric CSR)
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])

    # train features standardized (AmazonDataset.py:89-92)
    ds = Dataset(name="amazon2m", senders=s, receivers=r, features=feats,
                 labels=labels, train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask, n_classes=int(labels.max()) + 1)
    ds.normalize_features()
    np.savez(cache, senders=ds.senders, receivers=ds.receivers,
             features=ds.features, labels=ds.labels,
             train_mask=ds.train_mask, val_mask=ds.val_mask,
             test_mask=ds.test_mask, n_classes=ds.n_classes)
    return ds
