"""End-to-end LM training entry point with the SPACDC coded aggregation,
straggler injection, checkpoint/restart and elastic responder masks.

Ports ``repro/launch/train.py`` with its flags, prints and behaviour: the
model from the port's seeded ``build_model``, AdamW (weight decay 0.01)
under ``warmup_cosine(lr, 20, steps)`` over ``dict(model.named_
parameters())``, ``TokenPipeline`` batches, ``StragglerModel`` responder
masks, a checkpoint every ``--ckpt-every`` steps and at the end, and a
resume from the latest checkpoint found in ``--ckpt-dir``::

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --tiny --device cpu --steps 200 --coded --stragglers 1
  ... kill it mid-run, re-run the same command: it resumes from the
  checkpoint and ends where an uninterrupted run ends, bit for bit.

It runs on the card unless ``--device cpu`` is given.  ``--ckpt-dir``
defaults to ``repro_torch_ckpt`` in the temporary directory
(``tempfile.gettempdir()``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, tiny_config
from ..core import BerrutGradientCode
from ..data.pipeline import TokenPipeline
from ..models import build_model
from ..optim import adamw, warmup_cosine
from ..runtime.engine import resolve_device
from ..runtime.straggler import StragglerModel
from .steps import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=4,
                    help="coded gradient blocks (dp shards)")
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--stragglers", type=int, default=0,
                    help="drop this many blocks' contributions per step")
    ap.add_argument("--elastic-at", type=int, default=-1,
                    help="permanently lose one block from this step on")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg, device=dev, seed=args.seed)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"arch={cfg.name} params={n_params:,} coded={args.coded}")

    opt = adamw(warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01)
    opt_state = opt.init(params)
    gcode = BerrutGradientCode(args.blocks, args.blocks) if args.coded \
        else None
    step_fn = build_train_step(model, opt, accum=args.accum, gcode=gcode,
                               compress=args.compress)

    pipe = TokenPipeline(cfg.vocab_size, args.seq_len, args.global_batch,
                         args.seed)
    straggle = StragglerModel(args.blocks, args.stragglers, seed=args.seed)

    ck = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    latest = ck.latest_step()
    if latest is not None:
        restored = ck.restore(latest, {"params": params, "opt": opt_state})
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored["params"][name])
        opt_state = restored["opt"]
        start = latest
        print(f"resumed from checkpoint step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        mask = np.ones(args.blocks, np.float32)
        if args.coded and args.stragglers:
            mask = straggle.responder_mask(
                step, args.blocks - args.stragglers).astype(np.float32)
        if args.coded and 0 <= args.elastic_at <= step:
            mask[-1] = 0.0   # a block is gone for good; decode renormalizes
        params, opt_state, metrics = step_fn(params, opt_state,
                                             pipe.batch_at(step), mask)
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"responders={int(mask.sum())}/{args.blocks} "
                  f"({(time.time() - t0):.1f}s)")
        if (step + 1) % args.ckpt_every == 0:
            ck.save(step + 1, {"params": params, "opt": opt_state})
    ck.save(args.steps, {"params": params, "opt": opt_state})
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
