"""The port's benchmark layer (the JAX repo's ``bench.py`` and the
single-card scripts of ``benchmarks/``), on the card unless asked for
the CPU:

* :mod:`.entry` — the benchmark entry, ONE JSON line
  (``python3 bench_torch.py``, ``python -m gist_tpu_torch.bench``);
* :mod:`.spmm` — SpMM forward (and backward) by backend;
* :mod:`.kernel_tune` — K1 at tile sizes 64, 128 and 256, and a row
  gather rate;
* :mod:`.gat` — the GAT attention kernels and the GAT train step;
* :mod:`.sharded` — the sharded aggregation and GCN forward at D=1;
* the full-scale scripts: :mod:`.amazon_spmm` (K1 or K2 once per chunk
  over synth-amazon2m), :mod:`.gat_chunked` (K4 once per chunk at
  Reddit's edge count), :mod:`.uw_k1_probe` (the K=1 ultra-wide step
  rate), :mod:`.ist_sharded_2d` (the 2-D mesh beside its 1-D control),
  :mod:`.amazon_uw_fullscale` (ultra-wide, resumable by key) and
  :mod:`.cluster_fullscale` (the Cluster-GCN baseline);
* projections, records and cost models: :mod:`.scaling_projection` (the D-rank projection
  of one aggregation, its link rate an input), :mod:`.record_r2` (the
  round-2 records), :mod:`.amazon_split_analysis` and
  :mod:`.amazon_tn_analysis` (the cost models of the TPU kernel's
  gather wall, their rates measured or given), :mod:`.r4_figures` and
  :mod:`.r5_figures` (the figures, off the card);
* :mod:`.procs` — the one way to start a child process, and a time
  limit on every world of spawned ranks;
* :mod:`.timing` — the one timer; :mod:`.common` — rates, bounds,
  launch counts, the device stamp and the result files.
"""
