"""What a socket-mesh worker's start on the card is made of: phase 18 of
``chip_smoke.py`` alone (after the kernels are built), then 1, 8 and 30
(twice) fresh processes started together, each timing its ``import
torch``, its CUDA context, the port's worker import and the kernel
libraries' load (``_build.load_prebuilt``), as ``python -m
repro_torch.launch.worker`` paid them before the mesh forked its workers
from a fork server that imported torch once.  One JSON line per batch:
the wall until all are ready, the first ready, each stage's mean and max.

    python3 tools/worker_starts.py        # from the root of a checkout
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")

CHILD = r'''
import time, json, sys; t0 = time.time()
import torch; t1 = time.time()
torch.zeros(1, device="cuda"); torch.cuda.synchronize(); t2 = time.time()
sys.path.insert(0, "src")
from repro_torch.kernels import _build
import repro_torch.launch.worker; t3 = time.time()
_build.load_prebuilt(); t4 = time.time()
print(json.dumps({"t0": t0, "import_torch": t1 - t0, "context": t2 - t1,
                  "import_port": t3 - t2, "load_kernels": t4 - t3, "t4": t4}))
'''
KEYS = ("import_torch", "context", "import_port", "load_kernels")


def main() -> int:
    import torch
    import chip_smoke as cs
    print(cs.nvidia_smi(), flush=True)
    t = time.time()
    cs.build_kernels(torch)
    print("build_s", time.time() - t, flush=True)
    t = time.time()
    print(cs.acc_main_path(torch, torch.device("cuda")))
    print("phase18_s", time.time() - t, flush=True)
    for n in (1, 8, 30, 30):
        t = time.time()
        procs = [subprocess.Popen([sys.executable, "-c", CHILD],
                                  stdout=subprocess.PIPE, text=True,
                                  env=dict(os.environ, PYTHONPATH="src"))
                 for _ in range(n)]
        outs = [json.loads(p.communicate()[0]) for p in procs]
        print(json.dumps({"n": n, "wall_s": time.time() - t,
                          "first_ready_s": min(o["t4"] for o in outs) - t,
                          "mean": {k: sum(o[k] for o in outs) / n
                                   for k in KEYS},
                          "max": {k: max(o[k] for o in outs)
                                  for k in KEYS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
