"""The plain reference of the two models and of their IST round: the
forward passes, the loss, Adam, the boundary draws, the slicing of a
sub-model out of the full-width parameters and the merge back.  Plain
PyTorch in the parameters' dtype (fp32): no kernels of the program,
sums over edges by ``index_add_``; matrix products with TF32 off.

SAGE (the ISTSAGELayer stack, GIST's ``model/sage.py``): every layer
``h = [x || (A x) / in_deg]``, dropout on the concatenation, ``h @ w +
b``, then affine-free LayerNorm and ReLU on every layer but the last.
GAT: per layer and head ``z = x w``, scores ``leaky_relu(z_s . a_l +
z_r . a_r, 0.01)``, softmax over each receiver's edges, ``sum alpha
z_s``, the mean over heads, then ELU (after every layer).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VIRTUAL = 1 << 30      # padding id of a non-divisible split: reads 0
BETAS, EPS = (0.9, 0.999), 1e-8


def boundary_sizes(model: str, in_feats: int, n_hidden: int,
                   n_layers: int) -> list:
    """The split size of each boundary (``None``: not split).  SAGE: the
    hidden boundaries and the last one; GAT: the hidden ones."""
    if model == "sage":
        return [None] + [n_hidden] * n_layers
    return [None] + [n_hidden] * (n_layers - 1) + [None]


def _split(perm, size: int, k: int):
    c = -(-size // k)
    if k * c != size:
        perm = np.where(perm < size, perm, VIRTUAL) \
            if isinstance(perm, np.ndarray) \
            else torch.where(perm < size, perm, VIRTUAL)
    return perm.reshape(k, c)


def boundaries_host(rng: np.random.Generator, sizes: list, k: int) -> list:
    """The ultra-wide round's draw: a permutation a split boundary from a
    numpy generator."""
    return [None if s is None else
            _split(rng.permutation(k * -(-s // k)).astype(np.int64), s, k)
            for s in sizes]


def boundaries_torch(gen: torch.Generator, sizes: list, k: int) -> list:
    """The single-card round's draw: ``torch.randperm`` a split boundary
    from a CPU generator."""
    return [None if s is None else
            _split(torch.randperm(k * -(-s // k), generator=gen), s, k)
            for s in sizes]


def _take(a: torch.Tensor, idx, axis: int) -> torch.Tensor:
    """``a`` indexed on ``axis`` by ``idx`` (None: all), VIRTUAL ids 0."""
    if idx is None:
        return a
    idx = torch.as_tensor(idx, device=a.device)
    n = a.shape[axis]
    out = a.index_select(axis, idx.clamp(max=n - 1))
    shape = [1] * a.dim()
    shape[axis] = -1
    return torch.where((idx < n).view(shape), out, 0.0)


def _row_idx(b, half: int):
    return None if b is None else torch.cat(
        [torch.as_tensor(b), torch.as_tensor(b) + half])


def _bounds(bnds: list, i: int):
    return bnds[i], bnds[i + 1] if i + 1 < len(bnds) else None


def dispatch(model: str, full: dict, bnds: list, s: int) -> dict:
    """Subnet ``s``'s parameters sliced out of ``full``."""
    layers = []
    for i, layer in enumerate(full["layers"]):
        b_in, b_out = (None if b is None else b[s]
                       for b in _bounds(bnds, i))
        if model == "sage":
            w = _take(layer["w"], _row_idx(b_in, layer["w"].shape[0] // 2),
                      0)
            layers.append({"w": _take(w, b_out, 1),
                           "b": _take(layer["b"], b_out, 0)})
        else:
            w = _take(_take(layer["w"], b_in, 1), b_out, 2)
            attn = _take(layer["attn"],
                         _row_idx(b_out, layer["attn"].shape[1] // 2), 1)
            layers.append({"w": w, "attn": attn})
    return {"layers": layers}


def _mean(shards: torch.Tensor) -> torch.Tensor:
    """The shards' mean, summed as the program sums it where it merges:
    numpy's on the host, torch's on the card, so that the comparison can
    be exact whatever K."""
    if shards.device.type == "cpu":
        return torch.from_numpy(np.asarray(shards.numpy().mean(axis=0)))
    return shards.mean(dim=0)


def _scatter(full: torch.Tensor, shards: torch.Tensor, rows, cols,
             axis: int = 0) -> torch.Tensor:
    """Each shard written into a copy of ``full`` at its ``rows`` (on
    ``axis``) and ``cols`` (on ``axis + 1``), VIRTUAL ids dropped; the
    mean of the shards where neither is split."""
    if rows is None and cols is None:
        return _mean(shards)
    out = full.clone()
    lead = (slice(None),) * axis
    for s in range(shards.shape[0]):
        r = None if rows is None else torch.as_tensor(rows[s],
                                                      device=full.device)
        c = None if cols is None else torch.as_tensor(cols[s],
                                                      device=full.device)
        sh = shards[s]
        if r is not None:
            vr = r < full.shape[axis]
            r, sh = r[vr], sh[lead + (vr,)]
        if c is not None:
            vc = c < full.shape[axis + 1]
            c, sh = c[vc], sh[lead + (slice(None), vc)]
        if r is not None and c is not None:
            out[lead + (r[:, None], c[None, :])] = sh
        elif r is not None:
            out[lead + (r,)] = sh
        else:
            out[lead + (slice(None), c)] = sh
    return out


def merge(model: str, full: dict, bnds: list, stacked: dict) -> dict:
    """The trained shards (a leading subnet axis) written back into
    ``full``; unsplit leaves take the shards' mean."""
    layers = []
    for i, layer in enumerate(full["layers"]):
        b_in, b_out = _bounds(bnds, i)
        sub = stacked["layers"][i]
        if model == "sage":
            half = layer["w"].shape[0] // 2
            rows = None if b_in is None else [
                torch.cat([torch.as_tensor(r), torch.as_tensor(r) + half])
                for r in b_in]
            w = _scatter(layer["w"], sub["w"], rows, b_out)
            b = _scatter(layer["b"][:, None], sub["b"][:, :, None], b_out,
                         None)[:, 0] if b_out is not None \
                else _mean(sub["b"])
            layers.append({"w": w, "b": b})
        else:
            half = layer["attn"].shape[1] // 2
            cols = None if b_out is None else [
                torch.cat([torch.as_tensor(c), torch.as_tensor(c) + half])
                for c in b_out]
            layers.append({
                "w": _scatter(layer["w"], sub["w"], b_in, b_out, axis=1),
                "attn": _scatter(layer["attn"], sub["attn"], None, cols)})
    return {"layers": layers}


def sage_forward(layers: list, x: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, dropout: float,
                 gen: torch.Generator) -> torch.Tensor:
    """SAGE logits; dropout draws ``torch.rand`` of each concatenation's
    shape from ``gen``."""
    n = x.shape[0]
    deg = torch.bincount(dst, minlength=n).to(x.dtype)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)[:, None]
    h = x
    for i, layer in enumerate(layers):
        ah = torch.zeros_like(h).index_add_(0, dst, h[src]) * inv
        h = torch.cat([h, ah], dim=1)
        if dropout > 0:
            keep = 1.0 - dropout
            m = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(m, h / keep, 0.0)
        h = h @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            h = torch.relu(F.layer_norm(h, h.shape[-1:]))
    return h


def gat_forward(layers: list, x: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """GAT logits."""
    n = x.shape[0]
    h = x
    for layer in layers:
        w, a = layer["w"], layer["attn"]
        heads, d = w.shape[0], w.shape[2]
        z = torch.einsum("nf,hfo->nho", h, w)
        s_src = (z * a[:, :d]).sum(-1)
        s_dst = (z * a[:, d:]).sum(-1)
        e = F.leaky_relu(s_src[src] + s_dst[dst], 0.01)
        with torch.no_grad():
            mx = torch.full((n, heads), float("-inf"), dtype=e.dtype,
                            device=e.device)
            mx.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
        ex = torch.exp(e - mx[dst])
        den = torch.zeros((n, heads), dtype=e.dtype,
                          device=e.device).index_add_(0, dst, ex)
        alpha = ex / den[dst].clamp(min=1e-20)
        out = torch.zeros((n, heads, d), dtype=z.dtype,
                          device=z.device).index_add_(
            0, dst, alpha[..., None] * z[src])
        h = F.elu(out.mean(dim=1))
    return h


def adam_steps(leaves: list, loss_fn, batches: list, lr: float,
               weight_decay: float) -> tuple:
    """Adam with coupled L2 (the decay added to the gradient before the
    moments), one step a batch from fresh moments.  Returns (losses, the
    first step's gradient with the decay, the leaves after the steps)."""
    p = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses, g_first = [], None
    for t, batch in enumerate(batches, start=1):
        for q in p:
            q.requires_grad_(True)
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, p)
        losses.append(float(loss.detach()))
        p = [q.detach() for q in p]
        g = [gi + weight_decay * q for gi, q in zip(grads, p)]
        if g_first is None:
            g_first = g
        bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        for q, mi, vi, gi in zip(p, m, v, g):
            mi.mul_(BETAS[0]).add_(gi, alpha=1 - BETAS[0])
            vi.mul_(BETAS[1]).addcmul_(gi, gi, value=1 - BETAS[1])
            q.sub_(lr / bc1 * mi / (vi.sqrt() / bc2 ** 0.5 + EPS))
    return losses, g_first, p
