"""The benchmark's run of one cell: set-up, the measured window of whole
training rounds, the metrics and the check against the plain reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (the ``file`` of its ``configs`` entry), its
traffic (``perfbench/traffic/<traffic>.json``), the limits of its check
(``perfbench/limits/<cell>.json``), its round driver
(``perfbench/drivers/<driver>.py``, named by the configuration) and one
reader a metric (``perfbench/metrics/<metric>.py``).  A new cell, mix,
configuration or metric is a new file and a new entry; no file here
names one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import data
from perfbench.reference import check, flops, weights
from perfbench.reference.streams import CHECK, WEIGHTS, stream
from perfbench.trace import DeviceTrace, breakdown, busy_intervals, clip

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gist_tpu")
_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since import."""
    print(f"[perfbench {time.perf_counter() - _T0:8.1f} s] {msg}",
          file=sys.stderr, flush=True)


@dataclasses.dataclass
class Spec:
    """One cell, as ``BENCHMARK.json`` and the files it names hold it."""
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    def metrics(self, kind: str) -> list:
        """The ``kind`` ("end_to_end" or "per_layer") metrics this cell
        reports."""
        name = self.workload["name"]
        return [m for m in self.bench[kind]
                if name in m.get("workloads", [name])]


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_spec(root: str, workload: str) -> Spec:
    """The cell ``workload`` of the benchmark at ``root``."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    pb = os.path.join(root, "perfbench")
    return Spec(bench=bench, workload=cell,
                config=_read_json(os.path.join(root, entry["file"])),
                traffic=_read_json(os.path.join(
                    pb, "traffic", f"{cell['traffic']}.json")),
                limits=_read_json(os.path.join(
                    pb, "limits", f"{workload}.json")))


def _load(kind: str, name: str):
    """Module ``perfbench/<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Host spans ``(name, start_ns, end_ns, on_main_thread)`` on the
    wall clock (``time.time_ns``, the profiler's clock).  With ``sync``
    set, each span opens and closes on a device synchronisation, so that
    work queued before it does not count in it."""

    def __init__(self):
        self.records = []
        self.sync: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int, main: bool = True) -> None:
        with self._lock:
            self.records.append((name, t0, t1, main))

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            self.sync()
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.sync:
                self.sync()
            self.add(name, t0, time.time_ns())


class StepCapture:
    """Global optimizer hooks over the compared round: for each optimizer
    (one a subnet's burst, in order) its leaves before step 1, the
    gradient it got at step 1 (worked out from its state: Adam's first
    moment over 1 - beta1) and its leaves after step 3, on the host."""

    def __init__(self):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)
        self.steps, self.p0, self.g1, self.p3 = {}, [], [], []
        # held until removed, so that no optimizer's id is reused
        self.seen = []
        self.handles = [register_optimizer_step_pre_hook(self._pre),
                        register_optimizer_step_post_hook(self._post)]

    @staticmethod
    def _leaves(opt) -> list:
        return [p for g in opt.param_groups for p in g["params"]]

    def _pre(self, opt, args, kwargs):
        if id(opt) not in self.steps:
            self.steps[id(opt)] = 0
            self.seen.append(opt)
            self.p0.append([p.detach().cpu().clone()
                            for p in self._leaves(opt)])

    def _post(self, opt, args, kwargs):
        self.steps[id(opt)] += 1
        n = self.steps[id(opt)]
        if n == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            # a step that left no state got no gradient
            self.g1.append([
                opt.state[p]["exp_avg"].detach().cpu() / (1 - beta1)
                if "exp_avg" in opt.state[p]
                else torch.zeros_like(p, device="cpu")
                for p in self._leaves(opt)])
        elif n == 3:
            self.p3.append([p.detach().cpu().clone()
                            for p in self._leaves(opt)])

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.seen.clear()


class Run:
    """What a round driver is given: the cell's configuration and traffic,
    the run's seed, device and spans, the program's ``Dataset``, the cache
    directory and the benchmark's initial parameters; and where it hands
    every collection of batches (:meth:`record_batches`)."""

    def __init__(self, spec: Spec, seed: int, device, dataset, init,
                 cache_dir: str, dtype: str):
        self.config, self.traffic = spec.config, spec.traffic
        self.num_subnet = spec.traffic["num_subnet"]
        self.seed, self.device, self.dataset = seed, device, dataset
        self.init, self.cache_dir, self.dtype = init, cache_dir, dtype
        self.spans = Spans()
        self.collections = 0
        self.sampled = []
        self._pick = np.random.default_rng(stream(seed, CHECK))

    def record_batches(self, batches: list) -> None:
        """Keep, on the host, the batches of this collection that the
        check samples: the first three of the first collection, and
        ``check_batches`` drawn from the seed of every later one."""
        c, n = self.collections, len(batches)
        self.collections += 1
        picks = range(3) if c == 0 else self._pick.choice(
            n, size=min(self.traffic["check_batches"], n), replace=False)
        for i in picks:
            b = batches[i]
            e = b.n_real_edges
            self.sampled.append({
                "j": c * n + int(i),
                "ids": b.node_ids[:b.n_real_nodes].cpu().numpy().copy(),
                "src": b.graph.senders[:e].cpu().clone(),
                "dst": b.graph.receivers[:e].cpu().clone(),
                "n_pad": int(b.graph.n_nodes)})


class Record:
    """What the metrics' readers read: the window's rounds, spans and
    device operations, the set-up time and the model's shapes."""

    def __init__(self, spec: Spec, model: str, dims: list, rounds: list,
                 spans: list, t0_ns: int, t1_ns: int, window_s: float,
                 setup_s: float, ops: Optional[list]):
        self.spec, self.model, self.dims = spec, model, dims
        self.k = spec.traffic["num_subnet"]
        self.rounds, self.spans, self.ops = rounds, spans, ops
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s, self.setup_s = window_s, setup_s

    def batches(self):
        """(real nodes, real edges, padded nodes) of every batch the
        window trained, once per sub-model that trained on it."""
        for shapes in self.rounds:
            for b in shapes:
                for _ in range(self.k):
                    yield b

    def steps(self) -> int:
        return sum(1 for _ in self.batches())

    def nodes(self) -> int:
        return sum(n for n, _, _ in self.batches())

    def flops(self) -> int:
        return sum(flops.step_flops(self.model, self.dims, n, e)
                   for n, e, _ in self.batches())

    def span_s(self, *names: str) -> float:
        """Seconds of the named spans inside the window, every thread's."""
        return sum(max(0, min(b, self.t1_ns) - max(a, self.t0_ns))
                   for name, a, b, _ in self.spans if name in names) / 1e9

    def kernels(self, match: Callable[[str], bool]) -> list:
        """The window's device operations whose names ``match``."""
        return [o for o in self.ops or [] if match(o[0])]

    def busy_s(self) -> Optional[float]:
        """Seconds of the window in which a device operation ran (None
        without a trace)."""
        if self.ops is None:
            return None
        return sum(b - a for a, b in busy_intervals(self.ops)) / 1e9

    def traced_s(self) -> float:
        """The window's length on the trace's clock."""
        return (self.t1_ns - self.t0_ns) / 1e9


def read_metrics(spec: Spec, kind: str, rec: Record) -> dict:
    """Every ``kind`` metric of the cell whose reader finds something."""
    out = {}
    for m in spec.metrics(kind):
        value = _load("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _card_stamp(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    stamp = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1,
             "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        stamp["power_limit"] = res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        stamp["power_limit"] = "not read"
    return stamp


def initial_params(spec: Spec, model: str, ds, seed: int, device) -> dict:
    """The benchmark's initial full-width parameters, on ``device``."""
    cfg = spec.config
    g = torch.Generator(device=device).manual_seed(stream(seed, WEIGHTS))
    if model == "sage":
        return weights.sage_params(g, ds.in_feats, cfg["n_hidden"],
                                   ds.n_classes, cfg["n_layers"])
    return weights.gat_params(g, ds.in_feats, cfg["n_hidden"], ds.n_classes,
                              cfg["n_layers"], cfg["n_heads"])


class Cell:
    """One cell on one seed: its data, the program's round driver, and
    what the check needs.  :meth:`start` builds the driver and runs the
    warm-up rounds; :meth:`measure` runs the window;
    :meth:`compared_round` runs one more round, the one the check
    follows; :meth:`close` frees the program's state; :meth:`check`
    compares with the reference.  ``dtype`` overrides the
    configuration's (the lower-precision control); ``arrays`` are the
    graph's, where a caller already loaded them."""

    def __init__(self, root: str, workload: str, seed: int, device,
                 cache_dir: str, dtype: Optional[str] = None,
                 arrays: Optional[dict] = None):
        self.spec = spec = load_spec(root, workload)
        cfg = spec.config
        self.seed, self.device, self.cache_dir = seed, device, cache_dir
        self.sync = torch.cuda.synchronize if device.type == "cuda" \
            else None
        self.arrays = arrays or data.graph_arrays(cfg["dataset"], cache_dir)
        log(f"graph {cfg['dataset']}: {len(self.arrays['senders'])} edges")
        self.part_path = data.ensure_partition(cfg["dataset"], self.arrays,
                                               cfg["psize"], cache_dir)
        log(f"partition {cfg['psize']}")
        self.ds = data.dataset(cfg["dataset"], self.arrays)
        self.driver_mod = _load("drivers", cfg["driver"])
        self.model = self.driver_mod.MODEL
        self.dims = (flops.sage_dims if self.model == "sage"
                     else flops.gat_dims)(cfg, self.ds.in_feats,
                                          self.ds.n_classes,
                                          spec.traffic["num_subnet"])
        self.dtype = dtype or cfg["dtype"]
        self.rounds, self.first, self.compared = 0, {}, {}

    def next_round(self, capture: Optional[dict] = None) -> tuple:
        """One round of the driver, its ``capture`` filled (see the
        drivers); returns (its batches, its losses)."""
        self.driver.capture = capture
        out = self.driver.run_round()
        self.rounds += 1
        return out

    def start(self) -> None:
        """Build the driver and run the warm-up rounds, the first of them
        captured: the check holds its start and its merge by
        themselves."""
        init = initial_params(self.spec, self.model, self.ds, self.seed,
                              self.device)
        self.init_host = {"layers": [{k: v.cpu() for k, v in l.items()}
                                     for l in init["layers"]]}
        self.run = Run(self.spec, self.seed, self.device, self.ds, init,
                       self.cache_dir, self.dtype)
        self.driver = self.driver_mod.Driver(self.run)
        self.run.init = None
        del init
        log("driver built")
        self.next_round(self.first)
        for _ in range(self.spec.traffic["warmup_rounds"] - 1):
            self.next_round()
        if self.sync:
            self.sync()
        log("warm-up done")

    def compared_round(self) -> None:
        """One more round of the same driver after the window, untimed,
        under :class:`StepCapture`: the round the check follows, from the
        state the window's rounds left."""
        capture = StepCapture()
        compared = {"index": self.rounds}
        try:
            _, losses = self.next_round(compared)
        finally:
            capture.remove()
        compared.update(p0=capture.p0, g1=capture.g1, p3=capture.p3,
                        losses=losses)
        self.compared = compared
        if self.sync:
            self.sync()
        log(f"round {compared['index']} (compared)")

    def measure(self, seconds: float, trace: bool, t_start: float):
        """The window: whole rounds from now until the first to end past
        ``seconds``; returns (its record, the steps whose loss is not
        finite)."""
        on_card = self.device.type == "cuda"
        tracer = None
        if trace and on_card:
            tracer = DeviceTrace()
            self.run.spans.sync = self.sync
        self.run.spans.records.clear()
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        setup_s = t0 - t_start
        rounds, bad_losses, walls = [], 0, []
        while True:
            tr = time.perf_counter()
            batches, losses = self.next_round()
            walls.append(round(time.perf_counter() - tr, 3))
            rounds.append([(b.n_real_nodes, b.n_real_edges,
                            int(b.graph.n_nodes)) for b in batches])
            bad_losses += int((~np.isfinite(losses)).sum())
            if time.perf_counter() - t0 >= seconds:
                break
        if self.sync:
            self.sync()
        t1_ns, window_s = time.time_ns(), time.perf_counter() - t0
        ops = clip(tracer.stop(), t0_ns, t1_ns) if tracer else None
        self.run.spans.sync = None
        rec = Record(self.spec, self.model, self.dims, rounds,
                     list(self.run.spans.records), t0_ns, t1_ns, window_s,
                     setup_s, ops)
        log(f"window: {len(rounds)} rounds, {window_s:.2f} s; round walls "
            f"{walls}")
        return rec, bad_losses

    def close(self) -> None:
        """Free the program's state (the reference runs after it)."""
        self.driver.close()
        self.driver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Each compared number beside its limit."""
        numbers, self.detail = check.run_checks(
            self.model, self.spec.config, self.spec.traffic, self.ds,
            self.arrays, data.load_partition(self.part_path), self.seed,
            self.init_host, self.first, self.compared, self.run.sampled,
            self.device)
        log(f"check done; per-leaf gaps {json.dumps(self.detail)}")
        return {name: {"value": v, "limit": self.spec.limits[name]}
                for name, v in numbers.items()}


def passed(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device, cache_dir: str,
             dtype: Optional[str] = None) -> dict:
    """Set up the cell, measure its window, check it; returns the result
    (the last line's object).  ``t_start`` is the process's start on
    ``time.perf_counter``."""
    cell = Cell(root, workload, seed, device, cache_dir, dtype)
    cell.start()
    rec, bad_losses = cell.measure(seconds, trace, t_start)
    cell.compared_round()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    cell.close()
    metrics = read_metrics(cell.spec, "per_layer" if trace else "end_to_end",
                           rec)
    checks = cell.check()
    stamp = _card_stamp(device)
    stamp["memory_peak_bytes"] = int(peak)
    result = {"correct": passed(checks), "attempted": rec.steps(),
              "failed": bad_losses, "metrics": metrics, "device": stamp}
    if rec.ops is not None:
        stamp["busy_s"], stamp["window_s"] = rec.busy_s(), rec.traced_s()
        result["breakdown"] = breakdown(rec.ops, rec.spans, rec.t0_ns,
                                        rec.t1_ns)
    result["checks"] = checks
    return result
