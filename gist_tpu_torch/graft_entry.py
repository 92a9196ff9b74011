"""The single-card entry point of the JAX repo's ``__graft_entry__.py``
(``entry()``, lines 51-76): a forward step of the flagship model and its
example arguments.  The multi-rank dry run is
:mod:`gist_tpu_torch.dryrun`.

    import gist_tpu_torch.graft_entry as ge
    fn, args = ge.entry()            # on the card; entry("cpu") on the CPU
    logits = fn(*args)
"""

from __future__ import annotations


def entry(device="cuda"):
    """(fn, example_args): the forward of the Cluster-GCN GraphSAGE stack
    (``sage``, hidden 64, 2 layers) on synth-tiny, ``fn(params, x)``.
    On the card the graph carries its dedup layouts, so the forward runs
    K1; on the CPU it carries none and takes the segment path, as the
    JAX entry does off the TPU.  Raises without a card unless
    ``device="cpu"``."""
    import torch

    from gist_tpu_torch.data import synthetic_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.train.common import seeded_init
    from gist_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    ds = synthetic_dataset("synth-tiny")
    graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=dev.type == "cuda").to(dev)
    cfg = sage.SAGEConfig(ds.in_feats, 64, ds.n_classes, n_layers=2)
    params = seeded_init(sage, cfg, 0, dev)
    x = torch.from_numpy(ds.features).to(dev)

    def fwd(params, x):
        return sage.apply(params, graph, x, cfg)

    return fwd, (params, x)
