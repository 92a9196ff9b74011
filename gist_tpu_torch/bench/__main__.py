"""``python -m gist_tpu_torch.bench``: the benchmark entry."""

import sys

from gist_tpu_torch.bench.entry import main

sys.exit(main())
