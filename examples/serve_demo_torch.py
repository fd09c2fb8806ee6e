"""Coded continuous-batching demo on the PyTorch port: Poisson arrivals,
deadline-bounded greedy decode on a reduced deepseek (MLA absorbed-cache
decode path) — every per-step projection the spec selects (here: all of
them) runs inside ONE coded round per step, decoding at (or before) the
budget, whatever the stragglers do.  Requests are admitted as slots free
up and evicted the step they finish.  ``examples/serve_demo.py`` is its
JAX twin.

  PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]

Extra arguments pass straight through to ``repro_torch.launch.serve``
(argparse last-wins), so the same demo runs on any registered transport
backend or admission policy:

  PYTHONPATH=src python examples/serve_demo_torch.py --transport socket
  PYTHONPATH=src python examples/serve_demo_torch.py --uncoded
  PYTHONPATH=src python examples/serve_demo_torch.py --admission gated
"""

import sys

from repro_torch.launch import serve

ARGS = ["--arch", "deepseek-v2-lite-16b", "--tiny",
        "--requests", "6", "--rate", "30", "--slots", "4", "--ragged",
        "--prompt-len", "12", "--gen", "24",
        "--deadline-ms", "8", "--device", "cuda"]


def main(argv=None):
    return serve.main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
