"""The port's benchmark entry beside the JAX one (``bench.py``): ONE
JSON line, on the card unless ``--device cpu`` or ``GIST_BENCH_FAST=1``
asks for the CPU (``gist_tpu_torch/bench/entry.py``).

    python3 bench_torch.py [--device cpu] [--dataset NAME]
"""

import sys

from gist_tpu_torch.bench.entry import main

if __name__ == "__main__":
    sys.exit(main())
