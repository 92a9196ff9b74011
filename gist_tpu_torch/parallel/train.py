"""Full-graph training with node- and edge-sharded activations, one
step per model family: SAGE, GCN and GAT (``gist_tpu/parallel/train.py``).

Every rank of the mesh's ``graph`` dim holds a replica of the params
and its own rows of the activations, labels and masks; each layer's
aggregation does one ring halo exchange (``graph_shard.py``), the rest
is row-parallel.  The masked loss is each rank's sum over its rows
divided by the global mask count; the backward of the ring exchanges
sends the halo cotangents home, and the params' gradients are summed
over the dim, so every replica takes the same Adam step and the step
equals the single-device one.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.models.layers import layer_norm
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.parallel.graph_shard import (ShardedGraph,
                                                 ring_device_arrays)
from gist_tpu_torch.parallel.layers import (_inv_degree,
                                            sharded_gat_attention,
                                            sharded_sum_agg,
                                            sharded_whole_tensor_layer_norm)
from gist_tpu_torch.train.common import make_optimizer


def device_arrays(sg: ShardedGraph, mesh) -> dict:
    """This rank's bundle of what the sharded forwards read, on its
    device: :func:`graph_shard.ring_device_arrays` (with the interior
    dedup layouts when the graph carries them), its degrees and valid
    rows, and the ``graph`` dim's process group (``"group"``)."""
    rank = mesh.get_local_rank("graph")
    device = comm.mesh_device(mesh)
    dev = ring_device_arrays(sg, rank, device)
    dev["in_deg"] = sg.in_degrees[rank].to(device)
    dev["out_deg"] = sg.out_degrees[rank].to(device)
    dev["row_valid"] = sg.row_valid[rank].to(device)
    dev["group"] = mesh.get_group("graph")
    dev["rank"] = rank
    return dev


def sharded_sage_forward(sg: ShardedGraph, params: dict, x_loc, dev,
                         *, use_layernorm: bool = True, halo_dtype=None):
    """One rank's SAGE stack: every layer's ring halo exchange overlaps
    its interior sum; ``halo_dtype`` (e.g. bf16) on the wire only."""
    inv = _inv_degree(dev["in_deg"])
    h = x_loc
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        ah = sharded_sum_agg(sg, h, dev, halo_dtype) * inv
        h = torch.cat([h, ah], dim=1)
        h = h @ layer["w"] + layer["b"]
        if i != n - 1:
            if use_layernorm:
                h = layer_norm(h)
            h = torch.relu(h)
    return h


def sharded_gcn_forward(sg: ShardedGraph, params: dict, x_loc, dev,
                        *, use_layernorm: bool = True,
                        dropout: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        halo_dtype=None):
    """One rank's GCN stack: dropout before every layer but the first
    (drawn from ``generator``, the rank's own stream), the symmetric-norm
    GraphConv (rows scaled by the sender's norm before the halo
    exchange), ReLU and the whole-tensor LayerNorm (moments summed over
    the ranks, padded rows left out) after every layer but the last."""
    def rsqrt_deg(deg):
        return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                           torch.zeros_like(deg))[:, None]

    src_norm = rsqrt_deg(dev["out_deg"])
    dst_norm = rsqrt_deg(dev["in_deg"])
    h = x_loc
    layers = params["layers"]
    n = len(layers)
    for i, layer in enumerate(layers):
        if i != 0 and dropout > 0 and generator is not None:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < 1.0 - dropout
            h = torch.where(keep, h / (1.0 - dropout), 0.0)
        w, b = layer["w"], layer["b"]
        if w.shape[0] > w.shape[1]:      # project first (fewer FLOPs)
            h = sharded_sum_agg(sg, (h @ w) * src_norm, dev,
                                halo_dtype) * dst_norm
        else:
            h = sharded_sum_agg(sg, h * src_norm, dev,
                                halo_dtype) * dst_norm
            h = h @ w
        h = h + b
        if i != n - 1:
            h = torch.relu(h)
            if use_layernorm:
                h = sharded_whole_tensor_layer_norm(h, dev["row_valid"],
                                                    dev["group"])
    return h


def sharded_gat_forward(sg: ShardedGraph, params: dict, x_loc, dev,
                        *, negative_slope: float = 0.01, halo_dtype=None):
    """One rank's multi-head GAT (mean over heads, ELU after every layer,
    the last too); each layer's halo ships ``[z || src score]`` rows
    once."""
    h = x_loc
    for layer in params["layers"]:
        w, attn = layer["w"], layer["attn"]
        d_out = w.shape[2]
        z = torch.einsum("nf,hfo->nho", h, w).contiguous()
        src_s = torch.einsum("nho,ho->nh", z, attn[:, :d_out])
        dst_s = torch.einsum("nho,ho->nh", z, attn[:, d_out:])
        out = sharded_gat_attention(sg, z, src_s, dst_s, dev,
                                    negative_slope=negative_slope,
                                    halo_dtype=halo_dtype)
        h = torch.nn.functional.elu(out.mean(dim=1))
    return h


def sharded_forward(kind, sg, params, x_loc, dev, *, use_layernorm=True,
                    halo_dtype=None, dropout=0.0, generator=None):
    """The forward of model family ``kind`` (sage | gcn | gat)."""
    if kind == "sage":
        return sharded_sage_forward(sg, params, x_loc, dev,
                                    use_layernorm=use_layernorm,
                                    halo_dtype=halo_dtype)
    if kind == "gcn":
        return sharded_gcn_forward(sg, params, x_loc, dev,
                                   use_layernorm=use_layernorm,
                                   dropout=dropout, generator=generator,
                                   halo_dtype=halo_dtype)
    if kind == "gat":
        return sharded_gat_forward(sg, params, x_loc, dev,
                                   halo_dtype=halo_dtype)
    raise ValueError(f"unknown sharded model kind {kind!r}")


def masked_loss(logits, labels_loc, mask_loc, group):
    """(this rank's part of the global masked cross-entropy, the global
    loss's value).  The part is the rank's nll sum over the global mask
    count: the parts of all ranks sum to the loss, so each rank's
    backward from its own part gives the loss's gradient once."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels_loc.long()[:, None])[:, 0]
    m = mask_loc.to(logits.dtype)
    num = (nll * m).sum()
    den = comm.all_reduce_sum_(m.sum().detach().clone(), group).clamp(
        min=1.0)
    value = comm.all_reduce_sum_(num.detach().clone(), group) / den
    return num / den, value


def _leaves(params: dict):
    return [t for layer in params["layers"] for t in layer.values()]


def build_sharded_step(sg: ShardedGraph, mesh, *, kind: str = "sage",
                       lr: float, weight_decay: float,
                       use_layernorm: bool = True, halo_dtype=None,
                       dropout: float = 0.0):
    """``(init_opt, step)`` of a sharded full-graph training step of
    ``kind`` (sage | gcn | gat) on this rank.  ``opt = init_opt(params)``
    makes the Adam of the params (trained in place, each rank's replica);
    ``params, opt, loss = step(params, opt, x_loc, labels_loc,
    mask_loc[, generator])`` with this rank's rows; ``generator`` (the
    rank's dropout stream) is required when ``dropout > 0`` (GCN only).
    ``loss`` is the global loss, a 0-d tensor on every rank."""
    use_dropout = dropout > 0 and kind == "gcn"
    dev = device_arrays(sg, mesh)
    group = dev["group"]

    def init_opt(params):
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return make_optimizer(leaves, lr, weight_decay)

    def step(params, opt, x_loc, labels_loc, mask_loc, generator=None):
        if use_dropout and generator is None:
            raise TypeError("dropout > 0: step needs a generator")
        opt.zero_grad(set_to_none=False)
        logits = sharded_forward(
            kind, sg, params, x_loc, dev, use_layernorm=use_layernorm,
            halo_dtype=halo_dtype, dropout=dropout,
            generator=generator if use_dropout else None)
        part, value = masked_loss(logits, labels_loc, mask_loc, group)
        part.backward()
        comm.all_reduce_grads_(_leaves(params), group)
        opt.step()
        return params, opt, value

    return init_opt, step


def build_sharded_sage_step(sg: ShardedGraph, mesh, *, lr: float,
                            weight_decay: float, use_layernorm: bool = True,
                            halo_dtype=None):
    """:func:`build_sharded_step` with kind "sage"."""
    return build_sharded_step(sg, mesh, kind="sage", lr=lr,
                              weight_decay=weight_decay,
                              use_layernorm=use_layernorm,
                              halo_dtype=halo_dtype)


def build_sharded_infer(sg: ShardedGraph, mesh, *, kind: str = "sage",
                        use_layernorm: bool = True, halo_dtype=None):
    """``infer(params, x_loc) -> logits_loc``: this rank's rows of the
    sharded forward, with the training's wire dtype."""
    dev = device_arrays(sg, mesh)

    def run(params, x_loc):
        with torch.no_grad():
            return sharded_forward(kind, sg, params, x_loc, dev,
                                   use_layernorm=use_layernorm,
                                   halo_dtype=halo_dtype)

    return run


def build_sharded_sage_infer(sg: ShardedGraph, mesh, *,
                             use_layernorm: bool = True, halo_dtype=None):
    """:func:`build_sharded_infer` with kind "sage"."""
    return build_sharded_infer(sg, mesh, kind="sage",
                               use_layernorm=use_layernorm,
                               halo_dtype=halo_dtype)
