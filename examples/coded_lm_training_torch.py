"""Coded data-parallel LM training with stragglers + crash recovery, on the
PyTorch port.

Trains a reduced qwen2 with Berrut-coded gradient aggregation, drops a
random block's contribution every third step (straggler), then simulates
a pod loss at step 60 (elastic shrink — nothing is rebuilt, the decode
weights renormalize).  Checkpoints allow kill/resume at any point.
``examples/coded_lm_training.py`` is its JAX twin; this one runs on the
card and keeps its checkpoints under ``build/`` of the checkout.

  PYTHONPATH=src python examples/coded_lm_training_torch.py [--device cpu]
"""

import argparse
import shutil
from pathlib import Path

from repro_torch.launch import train

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "coded_lm_training"
ARGS = ["--arch", "qwen2-7b", "--tiny", "--coded",
        "--steps", "90", "--blocks", "4", "--stragglers", "1",
        "--elastic-at", "60", "--ckpt-dir", str(CKPT_DIR),
        "--global-batch", "16", "--seq-len", "64", "--log-every", "10"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the kernels' plain "
                    "versions)")
    args = ap.parse_args(argv)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return train.main(ARGS + ["--device", args.device])


if __name__ == "__main__":
    main()
