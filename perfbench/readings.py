"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 ... \
        [--controls 1 2 3] [--faults 1 2 3] [--seconds 2] [--out FILE]

For each of ``--seeds``: the program's set-up, a window of ``--seconds``
(a training cell's first checked step is set-up's, the others the
window's first), and the check: the
lower readings.  For each of ``--controls``: the reference computed in
the precision below the configuration's in the program's place (TF32 for
float32 products, fp8 for bf16 compute): the upper readings.  For each of
``--faults`` (training cells): the reference on half of each step's
micro-batches in the program's place.  One JSON line per reading, on
standard output and appended to ``--out``.  Not run by the benchmark's
runs; ``tests/test_perfbench_controls.py`` keeps the control at a size a
test run holds.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import core, devtrace  # noqa: E402

LOWER = {"coded_round": "tf32", "lm_train": "fp8"}


def driver_for(bench, workload, seed, seconds):
    cell = core.make_cell(bench, workload, seed, seconds, False)
    return cell.driver(), cell.traffic["driver"]


def free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    bench = core.load_json(core.ROOT / "BENCHMARK.json")

    def emit(row):
        row["device"] = torch.cuda.get_device_name()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    kept = {}
    for seed in args.seeds:
        t = time.perf_counter()
        drv, kind = driver_for(bench, args.workload, seed, args.seconds)
        drv.setup()
        drv.window(args.seconds, devtrace.Tracer(torch, enabled=False))
        drv.release()
        checks, attempted, failed = drv.check()
        emit({"reading": "program", "workload": args.workload, "seed": seed,
              "attempted": attempted, "failed": failed,
              "seconds": time.perf_counter() - t,
              **{c.name: c.value for c in checks},
              **({"worst_grad_leaf": drv.worst_grad_leaf,
                  "worst_change_leaf": drv.worst_change_leaf}
                 if kind == "lm_train" else {})})
        if seed in args.controls or seed in args.faults:
            kept[seed] = drv
        else:
            del drv
            free()
    for seed in args.controls:
        t = time.perf_counter()
        drv = kept.get(seed) or driver_for(bench, args.workload, seed,
                                           args.seconds)[0]
        kind = drv.cell.traffic["driver"]
        checks = (drv.control(LOWER[kind], drv.sample_k)
                  if kind == "coded_round" else drv.control(LOWER[kind]))
        emit({"reading": f"control_{LOWER[kind]}", "workload": args.workload,
              "seed": seed, "seconds": time.perf_counter() - t,
              **{c.name: c.value for c in checks}})
        free()
    for seed in args.faults:
        t = time.perf_counter()
        drv = kept.get(seed) or driver_for(bench, args.workload, seed,
                                           args.seconds)[0]
        checks = drv.control("float32", rows="half")
        emit({"reading": "fault_half_batch", "workload": args.workload,
              "seed": seed, "seconds": time.perf_counter() - t,
              **{c.name: c.value for c in checks}})
        free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
