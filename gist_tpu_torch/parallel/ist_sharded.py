"""IST on a 2-D ("subnet", "graph") mesh (``gist_tpu/parallel/
ist_sharded.py``): hidden width split over the ``subnet`` dim (GIST's
independent sub-networks) composed with graph sharding over ``graph``.

Every rank holds the full-width params and the round's boundaries (the
same on every rank), slices the sub-model of its subnet
(``mesh.get_local_rank("subnet")``), and trains it with the
graph-sharded forward over its row of the mesh: halo exchanges and the
gradient sum run over ``graph`` only.  The sync is one all_gather of
the trained shards over ``subnet`` and the same merge on every rank.
With S subnets and G graph shards the mesh has S * G ranks.
"""

from __future__ import annotations

import torch

from gist_tpu_torch.ist.slicing import dispatch, merge
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.parallel.graph_shard import ShardedGraph
from gist_tpu_torch.parallel.train import (_leaves, device_arrays,
                                           masked_loss, sharded_forward)
from gist_tpu_torch.train.common import make_optimizer


def make_ist_graph_mesh(num_subnet: int, num_graph: int, device="cuda"):
    """The 2-D mesh over every rank of the process group: rank
    ``s * num_graph + g`` is subnet s's graph shard g."""
    return comm.make_mesh(device, (num_subnet, num_graph),
                          ("subnet", "graph"))


def build_ist_sharded_round(sg: ShardedGraph, mesh, *, num_subnet: int,
                            kind: str = "sage", weight_decay: float = 0.0,
                            use_layernorm: bool = True, n_steps: int = 1,
                            halo_dtype=None):
    """``full_params, losses = round_fn(full_params, bnds, x_loc,
    labels_loc, mask_loc, lr)``: a fresh Adam at ``lr`` trains this
    rank's subnet for ``n_steps`` full-graph steps over its graph row,
    then the shards are gathered over ``subnet`` and merged.  ``x_loc``,
    ``labels_loc`` and ``mask_loc`` are this rank's rows of the graph
    dim; ``bnds`` the round's boundaries on the params' device.
    ``losses`` (num_subnet, n_steps) holds every subnet's global losses.
    (The JAX round also takes a key, which it folds and never uses.)"""
    dev = device_arrays(sg, mesh)
    graph_group = dev["group"]
    subnet_group = mesh.get_group("subnet")
    s = mesh.get_local_rank("subnet")

    def round_fn(full_params, bnds, x_loc, labels_loc, mask_loc, lr):
        sub = dispatch(full_params, bnds, s, kind)
        leaves = _leaves(sub)
        for t in leaves:
            t.requires_grad_(True)
        opt = make_optimizer(leaves, lr, weight_decay)
        losses = []
        for _ in range(n_steps):
            opt.zero_grad(set_to_none=False)
            logits = sharded_forward(kind, sg, sub, x_loc, dev,
                                     use_layernorm=use_layernorm,
                                     halo_dtype=halo_dtype)
            part, value = masked_loss(logits, labels_loc, mask_loc,
                                      graph_group)
            part.backward()
            comm.all_reduce_grads_(leaves, graph_group)
            opt.step()
            losses.append(value)
        for t in leaves:
            t.requires_grad_(False)
        stacked = comm.all_gather_tree(sub, subnet_group)
        full_params = merge(full_params, bnds, stacked, num_subnet, kind)
        return full_params, comm.all_gather_stack(torch.stack(losses),
                                                  subnet_group)

    return round_fn
