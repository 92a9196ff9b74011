"""The sweep registry (``gist_tpu/sweeps/configs.py``): the same
names and the same grids as the JAX package's, matching the reference's
script/ directory.  Dataset names default to the synthetic stand-ins;
pass the real names when the data is on disk.
"""

from gist_tpu_torch.sweeps.runner import grid

SWEEPS = {}


def register(name):
    def deco(fn):
        SWEEPS[name] = fn
        return fn
    return deco


@register("small-baseline")
def small_baseline(dataset="synth-cora"):
    """script/baseline_sweep.py:9-29 grid."""
    return grid(
        dataset=[dataset],
        n_hidden=[16, 64, 256, 1024],
        n_layers=[1, 2, 4, 8],
        lr=[5e-3, 1e-2, 5e-2, 1e-1],
        n_epochs=[400],
    )


@register("small-ist")
def small_ist(dataset="synth-cora"):
    """script/sweep.py:10-36 grid (GIST simulation)."""
    return grid(
        dataset=[dataset],
        n_hidden=[256],
        n_layers=[2],
        num_subnet=[2, 4, 8],
        iter_per_site=[1, 5, 10, 20, 35, 50],
        lr=[1e-2],
        split_output=[True],
    )


@register("reddit-baseline")
def reddit_baseline(dataset="synth-reddit-small"):
    """script/reddit/run_baseline_sweep_reddit.py:14-48 grid."""
    return grid(
        dataset=[dataset],
        n_hidden=[256],
        n_layers=[1, 2, 3, 4],
        psize=[1500],
        batch_size=[20],
        n_epochs=[40],
        lr=[3e-2],
        dropout=[0.2],
    )


@register("reddit-ist")
def reddit_ist(dataset="synth-reddit-small"):
    """script/reddit/run_ist_sweep_reddit.py:15-20 grid."""
    return grid(
        dataset=[dataset],
        n_hidden=[256],
        n_layers=[2, 3, 4],
        num_subnet=[2, 4, 8],
        iter_per_site=[100, 250, 500, 1000, 1500],
        psize=[1500],
        batch_size=[20],
        n_epochs=[80],
        lr=[3e-2],
        dropout=[0.2],
    )


@register("amazon-ultrawide")
def amazon_ultrawide(dataset="synth-amazon2m-small"):
    """script/amazon/run_ist_sweep_amazon_ultrawide.py:16-21 grid —
    the headline config family."""
    return grid(
        dataset=[dataset],
        n_hidden=[512, 1024, 2048],
        n_layers=[1, 2, 3, 4],
        num_subnet=[1, 2, 4, 8],
        iter_per_site=[5000],
        psize=[15000],
        batch_size=[10],
        n_epochs=[400],
        lr=[1e-2],
        dropout=[0.2],
        ultra_wide=[True],
    )


@register("reddit-lsgd")
def reddit_lsgd(dataset="synth-reddit-small"):
    """The local-SGD baseline grid the reference's sweep points at but
    never shipped (script/reddit/run_lsgd_sweep_reddit.py:63 references
    a missing cluster_gcn_lsgd_distrib.py; our train_ist_cluster
    lsgd=True implements it)."""
    return grid(
        dataset=[dataset], n_hidden=[256], n_layers=[2],
        num_subnet=[2, 4, 8], iter_per_site=[100, 500, 1500],
        psize=[1500], batch_size=[20], n_epochs=[80], lr=[3e-2],
        dropout=[0.2], lsgd=[True])


@register("reddit-ist-focus")
def reddit_ist_focus(dataset="synth-reddit-small"):
    """Round-2 focused tradeoff curves on the hardened generator:
    accuracy vs K at fixed iter_per_site, and vs iter_per_site at
    fixed K — the science the reference's full grid exists for,
    runnable in ~30 min on one chip."""
    k_curve = grid(
        dataset=[dataset], n_hidden=[256], n_layers=[2],
        num_subnet=[1, 2, 4, 8], iter_per_site=[500], psize=[1500],
        batch_size=[20], n_epochs=[80], lr=[3e-2], dropout=[0.2])
    ips_curve = grid(
        dataset=[dataset], n_hidden=[256], n_layers=[2], num_subnet=[4],
        iter_per_site=[100, 1000, 1500], psize=[1500], batch_size=[20],
        n_epochs=[80], lr=[3e-2], dropout=[0.2])
    return list(k_curve) + list(ips_curve)


@register("reddit-gat")
def reddit_gat(dataset="synth-reddit-small"):
    """script/reddit/run_gat_distrib_sweep.py:8-15 grid."""
    return grid(
        dataset=[dataset],
        n_hidden=[512],
        n_heads=[2, 4, 8],
        num_subnet=[2],
        iter_per_site=[500],
        n_epochs=[80],
    )


@register("gat-ist-focus")
def gat_ist_focus(dataset="synth-reddit-small"):
    """Round-2 GAT-IST accuracy recording on the hardened generator:
    the reference's heads axis (run_gat_distrib_sweep.py:8-15) plus a
    K=1 control per head count, at CPU-mesh-tractable width."""
    return grid(
        dataset=[dataset],
        n_hidden=[128],
        n_heads=[2, 4, 8],
        num_subnet=[1, 2],
        iter_per_site=[500],
        n_epochs=[80],
    )
