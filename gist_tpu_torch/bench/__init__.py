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
* :mod:`.timing` — the one timer; :mod:`.common` — rates, bounds,
  launch counts, the device stamp and the result files.
"""
