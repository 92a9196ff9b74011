"""Parameter trees between the two packages.

The JAX package's parameters (``init`` output, converted to numpy) and
the port's share one layout, so conversion is a copy per leaf: SAGE is
``{"layers": [{"w", "b"}]}`` with ``w`` (2*in, out) and ``b`` (out,),
GCN ``{"layers": [{"w", "b"}]}`` with ``w`` (in, out) and ``b`` (out,),
GAT ``{"layers": [{"w", "attn"}]}`` with ``w`` (heads, in, out) and
``attn`` (heads, 2*out).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cpu") -> dict:
    """numpy (or array-like) parameter tree -> tensors on ``device``."""
    return {"layers": [
        {k: torch.tensor(np.array(v, dtype=np.float32), device=device)
         for k, v in layer.items()}
        for layer in tree["layers"]]}


def params_to_numpy(params: dict) -> dict:
    """Tensor parameter tree -> numpy float arrays (host copies)."""
    return {"layers": [
        {k: v.detach().cpu().float().numpy() for k, v in layer.items()}
        for layer in params["layers"]]}
