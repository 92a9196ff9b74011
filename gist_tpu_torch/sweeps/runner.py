"""Grid sweep runner with JSONL persistence and resume
(``gist_tpu/sweeps/runner.py``)."""

from __future__ import annotations

import itertools
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, List


def grid(**axes) -> Iterator[Dict[str, Any]]:
    """Cartesian product of named axes, e.g.
    ``grid(n_hidden=[128, 256], num_subnet=[2, 4])``."""
    keys = list(axes)
    for values in itertools.product(*(axes[k] for k in keys)):
        yield dict(zip(keys, values))


class SweepRunner:
    """Runs ``fn(**config) -> result dict`` over a config iterable.

    * results append to ``<out>.jsonl`` (one object per run: config,
      result, wall time, status);
    * completed configs are skipped on rerun (resume), keyed by their
      sorted-JSON encoding — the reference's skip-if-in-pickle pattern
      (run_gat_distrib_sweep.py:18-22) made robust;
    * failures are recorded with the traceback instead of hanging the
      other runs (the reference's crashed rank stalls everyone at the
      next barrier, SURVEY.md §5 failure bullet).
    """

    def __init__(self, fn: Callable[..., dict], out_path: str,
                 trials: int = 1):
        self.fn = fn
        self.out_path = out_path
        self.trials = trials
        self._done = set()
        if os.path.exists(out_path):
            with open(out_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        # only successes count as done: errored configs
                        # retry on the next run (a crashed environment —
                        # e.g. too few devices — shouldn't poison the
                        # grid forever)
                        if rec.get("status") == "ok":
                            self._done.add(rec["key"])
                    except (json.JSONDecodeError, KeyError):
                        pass

    @staticmethod
    def _key(config: dict, trial: int) -> str:
        return json.dumps({"config": config, "trial": trial},
                          sort_keys=True, default=str)

    def run(self, configs: Iterable[dict], verbose: bool = True) -> List[dict]:
        os.makedirs(os.path.dirname(os.path.abspath(self.out_path)),
                    exist_ok=True)
        records = []
        for config in configs:
            for trial in range(self.trials):
                key = self._key(config, trial)
                if key in self._done:
                    continue
                t0 = time.time()
                from gist_tpu_torch.utils import hardware_tag
                rec = {"key": key, "config": config, "trial": trial,
                       "hardware": hardware_tag()}
                try:
                    result = self.fn(**config, trial=trial)
                    rec.update(status="ok", result=result)
                except Exception as e:  # record, don't stall the sweep
                    rec.update(status="error", error=str(e),
                               traceback=traceback.format_exc())
                rec["wall_s"] = time.time() - t0
                with open(self.out_path, "a") as f:
                    f.write(json.dumps(rec, default=float) + "\n")
                self._done.add(key)
                records.append(rec)
                if verbose:
                    tag = rec.get("status")
                    print(f"[sweep] {config} trial {trial}: {tag} "
                          f"({rec['wall_s']:.1f}s)", flush=True)
        return records


def summarize(jsonl_path: str, metric: str = "best_test") -> List[dict]:
    """Aggregate mean±std of a metric over trials per config — the
    CSV-aggregation step of the reference sweeps (5 seeds per cell,
    script/baseline_sweep.py:13,25), JSON-native.  Hardware tags are
    collected per cell so mixed-hardware cells are visible."""
    import collections
    import math

    by_config = collections.defaultdict(list)
    hw_by_config = collections.defaultdict(set)
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("status") != "ok":
                continue
            ckey = json.dumps(rec["config"], sort_keys=True, default=str)
            # trainers use either "best_test" (cluster) or
            # "best_test_acc" (full-graph/IST) naming
            val = rec["result"].get(metric,
                                    rec["result"].get(metric + "_acc"))
            if val is not None:
                by_config[ckey].append(val)
                hw_by_config[ckey].add(rec.get("hardware", "unknown"))
    out = []
    for ckey, vals in by_config.items():
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        out.append({"config": json.loads(ckey),
                    "n": len(vals),
                    "mean": mean,
                    "std": math.sqrt(var),
                    "max": max(vals),
                    "hardware": sorted(hw_by_config[ckey])})
    out.sort(key=lambda r: -r["mean"])
    return out
