"""Inference entry point (``gist_tpu/cli/infer.py``): load a training
checkpoint, run full-graph inference, report metrics and optionally
save the logits.

    python -m gist_tpu_torch.cli.infer --checkpoint-dir DIR \
        --dataset synth-tiny --n-hidden 16 [--model sage|gcn|gat] \
        [--cpu | --device cpu] [--logits-out logits.npy]

The serving side of the trainers: checkpoint -> predictions with the
plain ``apply`` of the model, on the card or, with ``--cpu``, on the
host.  ``--checkpoint-dir`` is a trainer's checkpoint root (its newest
``round_<k>`` is loaded) or one round directory.
"""

import argparse

import numpy as np
import torch

from gist_tpu_torch.cli.common import add_common_args, apply_backend, str2bool


def main(argv=None):
    p = argparse.ArgumentParser(description="gist_tpu_torch inference")
    add_common_args(p)
    p.add_argument("--checkpoint-dir", type=str, required=True)
    p.add_argument("--model", type=str, default="sage",
                   choices=["sage", "gcn", "gat"])
    p.add_argument("--n-heads", type=int, default=2)
    p.add_argument("--use-f1", action="store_true")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run inference on the host (ultra-wide models)")
    p.add_argument("--logits-out", type=str, default=None,
                   help="save logits to this .npy path")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    device = apply_backend(args)

    from gist_tpu_torch.convert import params_from_jax
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.models import gat, gcn, sage
    from gist_tpu_torch.models.common import micro_f1
    from gist_tpu_torch.train.checkpoint import (latest_round_dir,
                                                 load_checkpoint)
    from gist_tpu_torch.train.common import write_results

    ds = load_dataset(args.dataset, args.data_root)
    if args.normalize:
        ds.normalize_features()

    ck = latest_round_dir(args.checkpoint_dir) or args.checkpoint_dir
    state = load_checkpoint(ck)
    params = state["params"] if "params" in state else state
    print(f"loaded {ck}")

    mod = {"sage": sage, "gcn": gcn, "gat": gat}[args.model]
    if args.model == "gat":
        cfg = gat.GATConfig(ds.in_feats, args.n_hidden, ds.n_classes,
                            n_layers=max(args.n_layers, 2),
                            n_heads=args.n_heads)
    else:
        Cfg = sage.SAGEConfig if args.model == "sage" else gcn.GCNConfig
        cfg = Cfg(ds.in_feats, args.n_hidden, ds.n_classes,
                  n_layers=args.n_layers,
                  use_layernorm=str2bool(args.use_layernorm))

    graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(device)
    with torch.no_grad():
        logits = mod.apply(params_from_jax(params, device), graph,
                           torch.from_numpy(ds.features).to(device), cfg)
    logits = logits.cpu().numpy()

    results = {"checkpoint": ck, "dataset": ds.name}
    if ds.multitask:
        # threshold-at-0 micro-F1 on the multi-hot matrix
        results["val"] = micro_f1(logits, ds.labels_multi, ds.val_mask,
                                  multitask=True)
        results["test"] = micro_f1(logits, ds.labels_multi, ds.test_mask,
                                   multitask=True)
    elif args.use_f1:
        results["val"] = micro_f1(logits, ds.labels, ds.val_mask)
        results["test"] = micro_f1(logits, ds.labels, ds.test_mask)
    else:
        pred = logits.argmax(-1)
        results["val"] = float(
            (pred[ds.val_mask] == ds.labels[ds.val_mask]).mean())
        results["test"] = float(
            (pred[ds.test_mask] == ds.labels[ds.test_mask]).mean()) \
            if ds.test_mask.any() else results["val"]
    print(f"Val: {results['val']:.4f}  Test: {results['test']:.4f}")
    if args.logits_out:
        np.save(args.logits_out, logits)
        results["logits_out"] = args.logits_out
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
