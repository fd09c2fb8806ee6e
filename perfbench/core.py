"""The harness: run one cell of ``BENCHMARK.json`` once.

A run is set-up (the program built, the cell's inputs made from the seed,
every shape the window uses warmed), the measured window, and the check
that decides ``correct``, in that order.  ``setup_s`` runs from the
process's start to the window's.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the cell's per-layer metrics are read from
it; with ``--trace 0`` its end-to-end metrics are reported.  The check
runs once the window has closed, the peak memory has been read and the
program's state is freed.

Nothing here or in what it loads imports JAX or the JAX package: the
result is refused (exit 4, no line) if ``sys.modules`` holds one of them
once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
# top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

EXIT_NO_DEVICE, EXIT_FORBIDDEN, EXIT_NO_PROGRAM = 3, 4, 5


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock: its start
    time in ``/proc/self/stat`` (clock ticks since boot) against the boot
    clock now.  Without ``/proc``, the moment this module was imported."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        started = ticks / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def loaded_forbidden(names=FORBIDDEN) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``names``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in names})


def seed_of(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose (``keys``) of a run's ``--seed``,
    which may be any whole number: the same seed and keys give the same
    value, other keys an independent one."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & ((1 << 63) - 1)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    key = f"perfbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``ok`` when finite and at most
    the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Cell:
    """What a driver is handed: the cell's entries and files, the run's
    arguments, and the device."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    torch: object
    device: object

    def driver(self):
        """The driver the traffic file names, built for this cell."""
        return load_module("drivers", self.traffic["driver"]).Driver(self)

    def reference(self):
        """The plain reference that judges this cell: the one its
        configuration names."""
        return load_module("reference", self.config["reference"])


def make_cell(bench: dict, workload: str, seed: int, seconds: float,
              trace: bool, device=None) -> Cell:
    """The cell ``workload`` names, its files read; ``device`` defaults to
    the card."""
    import torch
    wl = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], wl["config"], "configuration")
    return Cell(workload=wl, config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH / "traffic" /
                                  f"{wl['traffic']}.json"),
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                torch=torch,
                device=torch.device("cuda" if device is None else device))


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics (``--trace 0``) or its per-layer ones (``--trace 1``); an
    entry with ``workloads`` counts only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device=None, t_start: Optional[float] = None,
             adjust: Optional[Callable[[Cell], None]] = None) -> dict:
    """One run of ``workload``: set-up, window, metrics, check.  Returns
    the result line's fields (``checks`` as ``Check``s).  ``device``
    defaults to the card; ``adjust(cell)`` may change the cell's entries
    before its driver is built (the CPU tests shrink the sizes)."""
    from . import devtrace
    t_enter = time.perf_counter()
    t_start = t_enter if t_start is None else t_start
    cell = make_cell(bench, workload, seed, seconds, trace, device)
    if adjust is not None:
        adjust(cell)
    torch, wl = cell.torch, cell.workload
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver = cell.driver()
    driver.setup()
    setup_s = time.perf_counter() - t_start
    tracer = devtrace.Tracer(torch, enabled=cell.trace and on_card)
    driver.window(cell.seconds, tracer)
    if on_card:
        torch.cuda.synchronize()
    if not driver.n_units:
        raise RuntimeError(f"{workload}: no round or step completed in a "
                           f"window of {cell.seconds} s")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    if cell.trace:
        view = tracer.view(driver.t0_ns, driver.t1_ns) if on_card else None
        ctx = MetricContext(driver=driver, view=view)
        for m in metrics_for(bench, workload, True):
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = dict(driver.end_to_end(), setup_s=setup_s)
        for m in metrics_for(bench, workload, False):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else cell.device.type,
                   "kind": (torch.cuda.get_device_name(cell.device)
                            if on_card else "cpu"),
                   "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"metrics": metrics, "device": device_info}
    if cell.trace and on_card:
        device_info["busy_s"] = view.busy_s
        device_info["window_s"] = view.window_s
        out["breakdown"] = view.breakdown()
    t_read = time.perf_counter()
    driver.release()
    checks, attempted, failed = driver.check()
    out.update(correct=bool(failed == 0 and checks and
                            all(c.ok for c in checks)),
               attempted=int(attempted), failed=int(failed), checks=checks,
               phases_s={"start": t_enter - t_start,
                         **getattr(driver, "setup_parts", {}),
                         "setup": setup_s,
                         "window": (driver.t1_ns - driver.t0_ns) / 1e9,
                         "to_check": t_read - t_start,
                         "check": time.perf_counter() - t_read})
    return out


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader gets: the driver (its counts, its
    window and the cell's work from shapes) and the window's trace
    (``devtrace.View``; None off the card)."""
    driver: object
    view: object


def result_line(result: dict) -> str:
    """The last line of standard output: the contract's keys, then the
    compared numbers with their limits, last."""
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in result["checks"]}
    return json.dumps(line)


def check_lines(result: dict) -> list:
    return [f"check {c.name}: {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in result["checks"]]


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return EXIT_NO_PROGRAM
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = int(find(bench["workloads"], args.workload, "workload")["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_DEVICE
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    print("perfbench: seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["phases_s"].items()),
        file=sys.stderr)
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result), flush=True)
    return 0
