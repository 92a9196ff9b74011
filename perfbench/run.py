"""The benchmark of ``gist_tpu_torch``: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted`` (sub-model steps in the window), ``failed`` (steps whose
loss is not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also close standard error.  Exits non-zero without a
result when no card (or too few) is visible, or when JAX or the JAX
package is loaded.

Caches (the graph, the partition, any compiler cache) live in
``perfbench/.cache`` of the checkout; the kernels build into
``gist_tpu_torch/_build``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch

    import gist_tpu_torch  # noqa: F401  (the system under test)
    from perfbench import harness

    chips = harness.load_spec(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s); {n} visible",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START,
                              torch.device("cuda", 0), CACHE)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the process that reports: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
