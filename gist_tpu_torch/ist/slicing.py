"""Dispatch (slice) and merge (scatter/average) of IST sub-model
parameters on the device (``gist_tpu/ist/slicing.py``).

For weight-layer i with boundary partitions ``B[i]`` (input side) and
``B[i+1]`` (output side), subnet s:

  dispatch:  w_s = w[rows(B[i][s]), :][:, B[i+1][s]]   (None -> full)
             b_s = b[B[i+1][s]]
  merge:     split dims scatter back; leaves with no split dim are
             averaged over subnets.

``rows`` is ``B[i][s]`` for gcn and ``[B, B + in]`` for sage (its weight
reads the concatenated ``[h || Ah]``); a gat weight (H, in, out) splits
axis 1 by ``B[i][s]`` and axis 2 by ``B[i+1][s]``, its ``attn``
(H, 2*out) by ``[B, B + out]`` of the output boundary.  Boundaries are
(K, chunk) integer tensors on the parameters' device or ``None``;
VIRTUAL_IDX entries read zero at dispatch and are dropped at merge.
Dispatch returns fresh tensors (the burst trains them in place), and
merge returns new full-width tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

Boundaries = Sequence[Optional[torch.Tensor]]  # each (K, chunk) or None


def _full_idx(idx: torch.Tensor, half: int) -> torch.Tensor:
    return torch.cat([idx, idx + half])


def _take(a: torch.Tensor, idx: Optional[torch.Tensor],
          axis: int) -> torch.Tensor:
    """``index_select`` whose out-of-range (VIRTUAL_IDX) entries read
    zero; a copy of ``a`` when ``idx`` is None."""
    if idx is None:
        return a.clone()
    n = a.shape[axis]
    out = a.index_select(axis, idx.clamp(max=n - 1))
    shape = [1] * a.dim()
    shape[axis] = -1
    return torch.where((idx < n).view(shape), out, 0.0)


def _sub(b: Optional[torch.Tensor], s: int) -> Optional[torch.Tensor]:
    return None if b is None else b[s]


def dispatch(params: dict, boundaries: Boundaries, s: int,
             kind: str = "gcn") -> dict:
    """Subnet ``s``'s parameters sliced out of the full-width ones."""
    out_layers = []
    for i, layer in enumerate(params["layers"]):
        b_in = _sub(boundaries[i], s)
        b_out = _sub(boundaries[i + 1], s) if i + 1 < len(boundaries) \
            else None
        if kind in ("gcn", "sage"):
            rows = b_in
            if kind == "sage" and b_in is not None:
                rows = _full_idx(b_in, layer["w"].shape[0] // 2)
            w = _take(_take(layer["w"], rows, 0), b_out, 1)
            out_layers.append({"w": w, "b": _take(layer["b"], b_out, 0)})
        elif kind == "gat":
            w = _take(_take(layer["w"], b_in, 1), b_out, 2)
            attn = layer["attn"]
            attn = _take(attn, None if b_out is None
                         else _full_idx(b_out, attn.shape[1] // 2), 1)
            out_layers.append({"w": w, "attn": attn})
        else:
            raise ValueError(kind)
    return {"layers": out_layers}


def stack(subs: Sequence[dict]) -> dict:
    """Sub-model parameter trees stacked leaf by leaf on a leading
    subnet axis (the all_gather's result)."""
    return {"layers": [
        {k: torch.stack([sub["layers"][i][k] for sub in subs])
         for k in layer}
        for i, layer in enumerate(subs[0]["layers"])]}


def dispatch_all(params: dict, boundaries: Boundaries, num_subnet: int,
                 kind: str = "gcn") -> dict:
    """Every subnet's shard, stacked on a leading (num_subnet,) axis."""
    return stack([dispatch(params, boundaries, s, kind)
                  for s in range(num_subnet)])


def _valid(idx: Optional[torch.Tensor], n: int):
    """(kept indices, mask) of an index row, dropping VIRTUAL_IDX."""
    if idx is None:
        return None, None
    keep = idx < n
    return idx[keep], keep


def _scatter(full: torch.Tensor, stacked: torch.Tensor,
             rows: Optional[torch.Tensor], cols: Optional[torch.Tensor],
             num_subnet: int, row_axis: int = 0) -> torch.Tensor:
    """Scatter each subnet's shard into a copy of ``full`` along
    ``row_axis`` and ``row_axis + 1``; average if neither is split."""
    if rows is None and cols is None:
        return stacked.mean(dim=0)
    out = full.clone()
    lead = (slice(None),) * row_axis
    n_r, n_c = full.shape[row_axis], full.shape[row_axis + 1]
    for s in range(num_subnet):
        r, vr = _valid(_sub(rows, s), n_r)
        c, vc = _valid(_sub(cols, s), n_c)
        shard = stacked[s]
        if r is not None and c is not None:
            out[lead + (r[:, None], c[None, :])] = \
                shard[lead + (vr,)][lead + (slice(None), vc)]
        elif r is not None:
            out[lead + (r,)] = shard[lead + (vr,)]
        else:
            out[lead + (slice(None), c)] = shard[lead + (slice(None), vc)]
    return out


def merge(params: dict, boundaries: Boundaries, stacked_sub: dict,
          num_subnet: int, kind: str = "gcn") -> dict:
    """Merge stacked trained shards (leading subnet axis) back into
    new full-width parameters."""
    out_layers = []
    for i, layer in enumerate(params["layers"]):
        b_in = boundaries[i]
        b_out = boundaries[i + 1] if i + 1 < len(boundaries) else None
        sub = stacked_sub["layers"][i]
        if kind in ("gcn", "sage"):
            rows = b_in
            if kind == "sage" and b_in is not None:
                half = layer["w"].shape[0] // 2
                rows = torch.cat([b_in, b_in + half], dim=1)
            out_layers.append({
                "w": _scatter(layer["w"], sub["w"], rows, b_out, num_subnet),
                "b": _scatter(layer["b"][:, None], sub["b"][:, :, None],
                              b_out, None, num_subnet)[:, 0]
                if b_out is not None else sub["b"].mean(dim=0)})
        elif kind == "gat":
            attn = layer["attn"]
            if b_out is None:
                attn = sub["attn"].mean(dim=0)
            else:
                half = attn.shape[1] // 2
                attn = _scatter(attn, sub["attn"], None,
                                torch.cat([b_out, b_out + half], dim=1),
                                num_subnet)
            out_layers.append({
                "w": _scatter(layer["w"], sub["w"], b_in, b_out, num_subnet,
                              row_axis=1),
                "attn": attn})
        else:
            raise ValueError(kind)
    return {"layers": out_layers}
