"""Rank functions of the port's multi-rank parity tests, run in gloo
worlds on the CPU by :func:`run_world`.

This module imports torch and the port only: ``torch.multiprocessing``
spawns each rank as a fresh interpreter that imports it by name, so a
child never imports JAX or ``conftest``'s XLA settings.  A test builds
its inputs (and the JAX side) in its own process, hands them to the
ranks as one pickled payload, and reads back what each rank returned.
"""

import os
import pickle
import tempfile

import numpy as np
import torch


def run_world(world: int, cases, payload=None, timeout_s: float = 300.0,
              init: bool = True):
    """Run every ``(name, args)`` of ``cases`` in order in one gloo world
    of ``world`` CPU ranks (rendezvous through a file; ``init=False``
    leaves the process group to the cases); returns
    ``{name: [rank 0's result, rank 1's, ...]}``."""
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(prefix="torch_dist_")
    with open(os.path.join(work, "in.pkl"), "wb") as f:
        pickle.dump((list(cases), payload), f)
    ctx = mp.start_processes(_entry, args=(world, work, init),
                             nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=timeout_s):
        pass
    out = {}
    for r in range(world):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            for name, res in pickle.load(f).items():
                out.setdefault(name, []).append(res)
    return out


def _entry(rank, world, work, init):
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if init:
        dist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                                rank=rank, world_size=world)
    try:
        with open(os.path.join(work, "in.pkl"), "rb") as f:
            cases, payload = pickle.load(f)
        results = {}
        for name, args in cases:
            fn = globals()[args.pop("fn")]
            results[name] = fn(rank, world, payload, **args)
        with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy().copy()


def _tree_np(tree):
    return {"layers": [{k: _np(v) for k, v in l.items()}
                       for l in tree["layers"]]}


def _tree_t(tree, device="cpu"):
    return {"layers": [{k: torch.tensor(np.array(v), device=device)
                        for k, v in l.items()} for l in tree["layers"]]}


# ---------------------------------------------------------------------------
# graph sharding
# ---------------------------------------------------------------------------

def aggregate(rank, world, payload, *, graph, variant, tiles,
              halo_dtype=None):
    """One sharded aggregation of ``payload[graph]``'s features and the
    gradient of ``sum(y * w)``: (y, dx) in node order, every rank's."""
    from gist_tpu_torch.parallel import comm, sharded_aggregate
    from gist_tpu_torch.parallel.graph_shard import (gather_unshard,
                                                     shard_features,
                                                     shard_rows)
    mesh = comm.make_mesh("cpu", (world,), ("graph",))
    g = payload[graph]
    from gist_tpu_torch.parallel import build_sharded_graph
    sg = build_sharded_graph(g["s"], g["r"], g["n"], world,
                             interior_tiles=tiles)
    if tiles:
        assert sg.int_dedup is not None
    hdt = torch.bfloat16 if halo_dtype == "bfloat16" else None
    if variant == "ring":
        agg = sharded_aggregate(sg, mesh, halo_dtype=hdt)
    else:
        agg = _a2a_aggregate(sg, mesh, overlapped=variant == "a2a_ov")
    x = shard_features(sg, g["x"], rank).requires_grad_(True)
    y = agg(x)
    n = sg.n_loc_pad
    w = torch.from_numpy(shard_rows(sg, g["w"])[rank * n:(rank + 1) * n])
    (y * w).sum().backward()
    group = mesh.get_group("graph")
    return _np(gather_unshard(sg, y, group)), \
        _np(gather_unshard(sg, x.grad, group))


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all`` of a (D, ...) CPU tensor over ``group``; its
    gradient is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, send, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def _a2a_aggregate(sg, mesh, overlapped):
    """JAX's all_to_all reference variants of the sharded aggregation
    (``_local_agg``, and the overlapped interior/boundary split) on the
    port's all_to_all layout arrays: every (i, j) block padded to
    ``halo_pad``.  The port itself aggregates through the ring only;
    this holds its a2a arrays to JAX's through the sums they drive."""
    from gist_tpu_torch.parallel.graph_shard import _segment_sum
    rank = mesh.get_local_rank("graph")
    group = mesh.get_group("graph")
    D, H, n = sg.n_devices, sg.halo_pad, sg.n_loc_pad

    def take(a):
        return a[rank].long()

    def run(x):
        f = x.shape[-1]
        send = x.index_select(0, take(sg.send_idx).reshape(-1))
        halo = _AllToAll.apply(send.reshape(D, H, f), group).reshape(D * H, f)
        if overlapped and D > 1:
            return (_segment_sum(x.index_select(0, take(sg.int_senders)),
                                 take(sg.int_receivers), n)
                    + _segment_sum(halo.index_select(0, take(sg.bnd_senders)),
                                   take(sg.bnd_receivers), n))
        full = torch.cat([x, halo])
        return _segment_sum(full.index_select(0, take(sg.senders)),
                            take(sg.receivers), n)
    return run


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------

def sharded_train(rank, world, payload, *, kind, steps, halo_dtype=None,
                  tiles=False, dropout=0.0, ds="ds"):
    """``steps`` sharded steps of ``kind`` from ``payload["init"][kind]``
    and the sharded infer after them: (losses, params, logits, the
    summed gradients of the first step, the infer's logits before the
    first step)."""
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import (gather_unshard,
                                                     shard_features,
                                                     shard_rows)
    from gist_tpu_torch.parallel.train import (build_sharded_infer,
                                               build_sharded_step)
    from gist_tpu_torch.utils import fold_in
    d = payload[ds]
    mesh = comm.make_mesh("cpu", (world,), ("graph",))
    sg = build_sharded_graph(d["s"], d["r"], d["n"], world,
                             interior_tiles=tiles)
    n = sg.n_loc_pad

    def rows(a):
        return torch.from_numpy(shard_rows(sg, a)[rank * n:(rank + 1) * n])

    x = shard_features(sg, d["x"], rank)
    lab, msk = rows(d["labels"].astype(np.int32)), rows(d["mask"])
    params = _tree_t(payload["init"][kind])
    hdt = torch.bfloat16 if halo_dtype == "bfloat16" else None
    init_opt, step = build_sharded_step(sg, mesh, kind=kind, lr=1e-2,
                                        weight_decay=0.0, halo_dtype=hdt,
                                        dropout=dropout)
    opt = init_opt(params)
    gen = torch.Generator().manual_seed(fold_in(7, rank))
    infer = build_sharded_infer(sg, mesh, kind=kind, halo_dtype=hdt)
    group = mesh.get_group("graph")
    logits0 = _np(gather_unshard(sg, infer(params, x), group))
    losses, grads = [], None
    for _ in range(steps):
        params, opt, loss = step(params, opt, x, lab, msk,
                                 gen if dropout > 0 else None)
        losses.append(float(loss))
        if grads is None:
            grads = {"layers": [{k: _np(v.grad) for k, v in l.items()}
                                for l in params["layers"]]}
    logits = _np(gather_unshard(sg, infer(params, x), group))
    return losses, _tree_np(params), logits, grads, logits0


def gat_hybrid(rank, world, payload, *, slope=0.01):
    """The sharded GAT attention through K4's plain walk (interior
    layouts) and through the segment path, with the gradients of
    ``sum(out * w)`` in z, src and dst: node-order arrays."""
    from gist_tpu_torch.parallel import (build_sharded_graph, comm,
                                         sharded_gat_attention)
    from gist_tpu_torch.parallel.graph_shard import (gather_unshard,
                                                     shard_rows)
    from gist_tpu_torch.parallel.train import device_arrays
    d = payload["gat"]
    mesh = comm.make_mesh("cpu", (world,), ("graph",))
    group = mesh.get_group("graph")
    out = {}
    for tiles in (True, False):
        sg = build_sharded_graph(d["s"], d["r"], d["n"], world,
                                 interior_tiles=tiles)
        n = sg.n_loc_pad
        if tiles:
            pos = sg.int_dedup.pos
            assert pos is not None and not bool(
                (pos[rank] == torch.arange(n, dtype=pos.dtype)).all())

        def rows(a):
            return torch.from_numpy(
                shard_rows(sg, a)[rank * n:(rank + 1) * n])

        dev = device_arrays(sg, mesh)
        z, src, dst = (rows(d[k]).requires_grad_(True)
                       for k in ("z", "src", "dst"))
        o = sharded_gat_attention(sg, z, src, dst, dev,
                                  negative_slope=slope)
        (o * rows(d["w"])).sum().backward()
        out["tiles" if tiles else "segment"] = [
            _np(gather_unshard(sg, t, group))
            for t in (o, z.grad, src.grad, dst.grad)]
    return out


# ---------------------------------------------------------------------------
# IST over a subnet mesh
# ---------------------------------------------------------------------------

def _dataset(name):
    from gist_tpu_torch.data import load_dataset
    return load_dataset(name)


def ist_round(rank, world, payload, *, kind):
    """One ``build_ist_round`` over inline full-graph batches with the
    payload's boundaries: (merged params, losses)."""
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ist.distributed import (build_ist_round,
                                                make_subnet_mesh)
    from gist_tpu_torch.models import gcn, sage
    mesh = make_subnet_mesh(world, "cpu")
    d = payload["round"]
    model = {"gcn": gcn, "sage": sage}[kind]
    cfg = payload["cfg"][kind]
    g = graph_from_edges(d["s"], d["r"], d["n"])
    batch = (g, torch.from_numpy(d["x"]), torch.from_numpy(d["labels"]),
             torch.from_numpy(d["mask"]))
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=world)
    round_fn = build_ist_round(model, sub_cfg, mesh=mesh, kind=kind,
                               num_subnet=world, weight_decay=5e-4,
                               split_input=False)
    bnds = [None if b is None else torch.from_numpy(b).long()
            for b in payload["bnds"][kind]]
    full, losses = round_fn(_tree_t(payload["init"][kind]), bnds,
                            [batch] * 3, 1e-2, 0, None)
    return _tree_np(full), _np(losses)


def run_ist(rank, world, payload):
    """``run_distributed_ist`` on synth-tiny (GCN, dropout 0) with the
    payload's per-round boundaries injected."""
    from gist_tpu_torch.ist import distributed as TD
    from gist_tpu_torch.models import gcn
    from gist_tpu_torch.train.common import TrainConfig
    rounds = [[None if b is None else torch.from_numpy(b).long() for b in r]
              for r in payload["run_bnds"]]
    TD.sample_boundaries = lambda gen, sizes, k: rounds.pop(0)
    res = TD.run_distributed_ist(
        _dataset("synth-tiny"), payload["run_cfg"],
        TrainConfig(**payload["run_tc"]), model=gcn, kind="gcn",
        init_params=payload["run_init"], device="cpu", verbose=False)
    assert not rounds
    return res


def _patch_trainer(module, rounds):
    from gist_tpu_torch import sampler as TSampler
    from gist_tpu_torch.ops import spmm as TS
    rounds = [[None if b is None else torch.from_numpy(np.array(b)).long()
               for b in r] for r in rounds]
    module.sample_boundaries = lambda gen, sz, kk: rounds.pop(0)
    TS._DEFAULT_BACKEND = "dedup"
    TSampler.TILES_MIN_EDGES = 0
    return rounds


def ist_cluster(rank, world, payload, *, case):
    """``train_ist_cluster(mesh=...)`` of ``payload[case]`` with the
    JAX trainer's boundaries injected."""
    from gist_tpu_torch.ist.distributed import make_subnet_mesh
    from gist_tpu_torch.models import gat, gcn, sage
    from gist_tpu_torch.train import ist_cluster as TIC
    from gist_tpu_torch.train.common import TrainConfig
    c = payload[case]
    rounds = _patch_trainer(TIC, c["rounds"])
    mesh = make_subnet_mesh(world, "cpu")
    model = {"gat": gat, "gcn": gcn, "sage": sage}[c["kind"]]
    res = TIC.train_ist_cluster(
        _dataset("synth-tiny"), c["cfg"], TrainConfig(**c["tc"]),
        model=model, kind=c["kind"], init_params=c["init"], mesh=mesh,
        device="cpu", **c["common"])
    assert not rounds
    return res


def ist_ultrawide(rank, world, payload, *, sequential):
    """``train_ist_ultrawide`` on a subnet mesh (or sequentially on each
    rank, the reference) from the payload's init; the host boundary
    draws are the trainer's own, seeded alike everywhere."""
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    from gist_tpu_torch import sampler as TSampler
    from gist_tpu_torch.ops import spmm as TS
    # the segment path, as the single-card ultra-wide tests run it (an
    # earlier case of the world may have forced the dedup backend)
    TS._DEFAULT_BACKEND = "auto"
    TSampler.TILES_MIN_EDGES = 200_000
    c = payload["uw"]
    return train_ist_ultrawide(
        _dataset("synth-tiny"), c["cfg"], TrainConfig(**c["tc"]),
        model=sage, kind="sage", init_params=c["init"],
        sequential=sequential, device="cpu", **c["common"])


def ist_sharded(rank, world, payload, *, kind, n_subnet):
    """One ``build_ist_sharded_round`` on a (n_subnet, world / n_subnet)
    mesh: (merged params, losses)."""
    from gist_tpu_torch.parallel import build_sharded_graph
    from gist_tpu_torch.parallel.graph_shard import shard_features, shard_rows
    from gist_tpu_torch.parallel.ist_sharded import (build_ist_sharded_round,
                                                     make_ist_graph_mesh)
    gd = world // n_subnet
    mesh = make_ist_graph_mesh(n_subnet, gd, "cpu")
    d = payload["ds"]
    sg = build_sharded_graph(d["s"], d["r"], d["n"], gd,
                             interior_tiles=False)
    gr = mesh.get_local_rank("graph")
    n = sg.n_loc_pad

    def rows(a):
        return torch.from_numpy(shard_rows(sg, a)[gr * n:(gr + 1) * n])

    round_fn = build_ist_sharded_round(sg, mesh, num_subnet=n_subnet,
                                       kind=kind, n_steps=3)
    bnds = [None if b is None else torch.from_numpy(np.array(b)).long()
            for b in payload["bnds2d"][kind]]
    full, losses = round_fn(_tree_t(payload["init"][kind]), bnds,
                            shard_features(sg, d["x"], gr),
                            rows(d["labels"].astype(np.int32)),
                            rows(d["mask"]), 1e-2)
    return _tree_np(full), _np(losses)


def cli(rank, world, payload, *, argv):
    """``cli.sharded_train.main`` in the initialised world."""
    from gist_tpu_torch.cli.sharded_train import main
    return main(argv)


def multihost(rank, world, payload):
    """``init_multihost`` without an environment, then from a launcher's
    environment: (first return, second return, world size, an
    all_reduce of rank + 1, a third call's return)."""
    import torch.distributed as dist
    from gist_tpu_torch.multihost import init_multihost
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(v, None)
    bare = init_multihost(device="cpu")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost",
                      MASTER_PORT=str(payload["port"]))
    ok = init_multihost(device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    again = init_multihost(device="cpu")
    return bare, ok, dist.get_world_size(), float(t), again
