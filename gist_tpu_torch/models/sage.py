"""GraphSAGE-style stacks (``gist_tpu/models/sage.py``).

* :func:`init`/:func:`apply` — the IST-capable stack: ISTSAGELayers
  (affine-free LayerNorm, dropout between concat and linear), LayerNorm
  + ReLU on every layer but the output layer.
* :func:`init_graphsage`/:func:`apply_graphsage` — the plain GraphSAGE
  stack, with affine LayerNorm on every layer but the output layer.

Parameters are ``{"layers": [{"w": (2*in, out), "b": (out,)}]}`` of
tensors (plus ``ln_scale``/``ln_bias`` (out,) on the plain stack's
affine layers).  With ``use_pp`` the sampler's features are already
``[x || (A x)/deg]`` (2*in wide) and both stacks skip the first layer's
aggregation in training; the eval reads the raw features and
aggregates.  :func:`apply_chunked_host` is the memory-bounded full-graph
eval on the host for widths whose activations exceed device memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.models.common import ist_layer_dims, torch_linear_uniform
from gist_tpu_torch.models.layers import sage_layer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SAGEConfig:
    in_feats: int
    n_hidden: int
    n_classes: int
    n_layers: int = 1          # hidden layers; stack = n_layers + 1
    dropout: float = 0.2
    use_layernorm: bool = True
    split_input: bool = False
    split_output: bool = False
    num_subnet: int = 1
    use_pp: bool = False       # first-layer aggregation precomputed
    # compute dtype inside apply ("float32" or "bfloat16"); logits are
    # always returned fp32
    dtype: str = "float32"

    def layer_dims(self):
        return ist_layer_dims(
            self.in_feats, self.n_hidden, self.n_classes, self.n_layers,
            split_input=self.split_input, split_output=self.split_output,
            num_subnet=self.num_subnet)

    def sub_config(self, *, split_input: bool, split_output: bool,
                   num_subnet: int) -> "SAGEConfig":
        return replace(self, split_input=split_input,
                       split_output=split_output, num_subnet=num_subnet)


def init(generator: torch.Generator, cfg: SAGEConfig) -> dict:
    """w and b ~ U(-s, s), s = 1/sqrt(2*in), drawn from ``generator``
    (on the generator's device)."""
    layers = []
    for d_in, d_out in cfg.layer_dims():
        fan_in = 2 * d_in
        layers.append({
            "w": torch_linear_uniform(generator, (2 * d_in, d_out), fan_in),
            "b": torch_linear_uniform(generator, (d_out,), fan_in),
        })
    return {"layers": layers}


def apply(
    params: dict,
    graph: Graph,
    x: torch.Tensor,
    cfg: SAGEConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Stack forward: every layer aggregates, but for the first in train
    mode with ``cfg.use_pp``; dropout draws from ``generator`` in train
    mode."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    layers = params["layers"]
    n = len(layers)
    h = x
    if cfg.dtype != "float32":
        dt = _DTYPES[cfg.dtype]
        h = h.to(dt)
        layers = [{k: v.to(dt) for k, v in layer.items()} for layer in layers]
    for i, layer in enumerate(layers):
        is_last = i == n - 1
        h = sage_layer(
            graph, h, layer,
            dropout_rate=cfg.dropout if train else 0.0,
            generator=generator if train else None,
            use_layer_norm=cfg.use_layernorm and not is_last,
            activation=None if is_last else torch.relu,
            aggregate_first=not (i == 0 and cfg.use_pp and train),
            backend=backend,
        )
    return h.float()


def apply_chunked_host(
    params: dict,
    senders,
    receivers,
    x,
    cfg: SAGEConfig,
    *,
    node_chunk: int = 131_072,
    store_dtype=None,
):
    """Memory-bounded full-graph eval forward on the HOST; returns the
    fp32 logits as a numpy array.

    The ultra-wide regime evaluates a full-width model on the full
    graph; at h2048 x 2.45M nodes the plain :func:`apply` would hold a
    40 GB ``[h || Ah]`` concat.  This walks the same math (aggregate ->
    concat -> linear -> affine-free LayerNorm -> ReLU) with bounded
    intermediates: the aggregation in 512-column slices of a receiver-
    row CSR matrix, the linears in ``node_chunk``-node chunks, fp16
    storage of the activations (``store_dtype``) and fp32 compute, and
    an fp32 output layer.  ``params`` is a numpy (or array-like) tree.
    Eval only: no dropout, and no ``use_pp`` skip (the eval aggregates).

    ``GIST_EVAL_BACKEND`` picks the path: ``auto`` (default) and
    ``torch`` take the torch-CPU one (:func:`_apply_chunked_torch`,
    multithreaded sparse-CSR SpMM and GEMM), ``numpy`` the scipy/numpy
    one; both compute the same thing and are held against each other.
    The JAX package also has a numpy ``reduceat`` aggregation for hosts
    without scipy; the port needs scipy and leaves it out."""
    import scipy.sparse as sp

    store_dtype = store_dtype or np.float16
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    n = x.shape[0]
    backend = os.environ.get("GIST_EVAL_BACKEND", "auto")
    if backend not in ("auto", "torch", "numpy"):
        raise ValueError(f"GIST_EVAL_BACKEND must be auto, torch or numpy, "
                         f"not {backend!r}")
    if backend in ("auto", "torch"):
        return _apply_chunked_torch(params, senders, receivers, x, cfg,
                                    node_chunk=node_chunk,
                                    store_dtype=store_dtype)
    A = sp.csr_matrix(
        (np.ones(len(senders), np.float32), (receivers, senders)),
        shape=(n, n))
    deg = np.bincount(receivers, minlength=n)[:n].astype(np.float32)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0),
                       0.0).astype(np.float32)[:, None]

    h = np.asarray(x, np.float32).astype(store_dtype)
    layers = params["layers"]
    col_chunk = 512
    for li, layer in enumerate(layers):
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        f = h.shape[1]
        ah = np.zeros((n, f), np.float32)
        for c in range(0, f, col_chunk):
            d = min(c + col_chunk, f)
            ah[:, c:d] = A @ h[:, c:d].astype(np.float32)
        ah *= inv_deg
        is_last = li == len(layers) - 1
        out = np.empty((n, w.shape[1]),
                       np.float32 if is_last else store_dtype)
        for i in range(0, n, node_chunk):
            j = min(i + node_chunk, n)
            hcat = np.concatenate(
                [h[i:j].astype(np.float32), ah[i:j]], axis=1)
            o = hcat @ w + b
            if cfg.use_layernorm and not is_last:
                o -= o.mean(axis=1, keepdims=True)
                o /= np.sqrt(o.var(axis=1, keepdims=True) + 1e-5)
            if not is_last:
                np.maximum(o, 0.0, out=o)
            out[i:j] = o
        del ah
        h = out
    return h


def _apply_chunked_torch(params, senders, receivers, x, cfg, *,
                         node_chunk, store_dtype):
    """torch-CPU path of :func:`apply_chunked_host`: the same math, with
    ATen's parallel sparse-CSR SpMM and GEMM.  The CSR matrix is built
    by scipy and handed to torch; activations and parameters enter
    through ``torch.from_numpy`` without copies, and the logits leave
    through one ``.numpy()``."""
    import scipy.sparse as sp

    n = x.shape[0]
    store_t = torch.float16 if store_dtype == np.float16 else torch.float32
    A = sp.csr_matrix(
        (np.ones(len(senders), np.float32), (receivers, senders)),
        shape=(n, n))
    At = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=(n, n))
    deg = np.bincount(receivers, minlength=n)[:n].astype(np.float32)
    inv_deg = torch.from_numpy(
        np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0))[:, None]

    h = torch.from_numpy(np.asarray(x, np.float32)).to(store_t)
    layers = params["layers"]
    col_chunk = 512
    with torch.no_grad():
        for li, layer in enumerate(layers):
            w = torch.from_numpy(np.asarray(layer["w"], np.float32))
            b = torch.from_numpy(np.asarray(layer["b"], np.float32))
            f = h.shape[1]
            ah = torch.empty((n, f), dtype=torch.float32)
            for c in range(0, f, col_chunk):
                d = min(c + col_chunk, f)
                ah[:, c:d] = At @ h[:, c:d].float()
            ah *= inv_deg
            is_last = li == len(layers) - 1
            out = torch.empty((n, w.shape[1]),
                              dtype=torch.float32 if is_last else store_t)
            for i in range(0, n, node_chunk):
                j = min(i + node_chunk, n)
                hcat = torch.cat([h[i:j].float(), ah[i:j]], dim=1)
                o = hcat @ w + b
                if cfg.use_layernorm and not is_last:
                    o -= o.mean(dim=1, keepdim=True)
                    o /= torch.sqrt(o.var(dim=1, unbiased=False,
                                          keepdim=True) + 1e-5)
                if not is_last:
                    o.clamp_(min=0.0)
                out[i:j] = o.to(out.dtype)
            del ah
            h = out
    return h.numpy()


def init_graphsage(generator: torch.Generator, cfg: SAGEConfig) -> dict:
    """The plain GraphSAGE stack: ``n_layers`` hidden layers of width
    ``n_hidden`` and the output layer, w and b ~ U(-s, s), s =
    1/sqrt(2*in); every layer but the output one has an affine
    LayerNorm (scale 1, bias 0)."""
    dims = [(cfg.in_feats, cfg.n_hidden)]
    dims += [(cfg.n_hidden, cfg.n_hidden)] * (cfg.n_layers - 1)
    dims += [(cfg.n_hidden, cfg.n_classes)]
    layers = []
    for i, (d_in, d_out) in enumerate(dims):
        fan_in = 2 * d_in
        layer = {
            "w": torch_linear_uniform(generator, (2 * d_in, d_out), fan_in),
            "b": torch_linear_uniform(generator, (d_out,), fan_in),
        }
        if i < len(dims) - 1:
            layer["ln_scale"] = torch.ones(d_out, device=generator.device)
            layer["ln_bias"] = torch.zeros(d_out, device=generator.device)
        layers.append(layer)
    return {"layers": layers}


def apply_graphsage(
    params: dict,
    graph: Graph,
    x: torch.Tensor,
    cfg: SAGEConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """The plain GraphSAGE forward: affine LayerNorm + ReLU on every
    layer but the last, whatever ``cfg.use_layernorm``; with
    ``cfg.use_pp`` the first layer skips its aggregation in training."""
    layers = params["layers"]
    n = len(layers)
    h = x
    for i, layer in enumerate(layers):
        is_last = i == n - 1
        h = sage_layer(
            graph, h, layer,
            dropout_rate=cfg.dropout if train else 0.0,
            generator=generator if train else None,
            use_layer_norm=not is_last,
            affine_ln=not is_last,
            activation=None if is_last else torch.relu,
            aggregate_first=not (i == 0 and cfg.use_pp and train),
            backend=backend,
        )
    return h
