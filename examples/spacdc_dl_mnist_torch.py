"""The paper's experiment (§VII-B) on the PyTorch port: SPACDC-DL vs
CONV/MDS/MATDOT-DL.

Trains an MLP on MNIST-shaped synthetic data with N=30 simulated workers,
T=3 colluding, S stragglers; the backward products are computed through
each coding scheme and the virtual-clock round times reproduce Fig. 3/4's
qualitative result: SPACDC-DL reaches target accuracy fastest once
stragglers push survivors below the classical schemes' recovery
thresholds.  One ``ClusterSpec`` per scheme; the training loop is
``Session.train_step``, on the card unless ``--device`` says otherwise.
``examples/spacdc_dl_mnist.py`` is its JAX twin.

  PYTHONPATH=src python examples/spacdc_dl_mnist_torch.py [--stragglers 5]
"""

import argparse

import numpy as np
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec,
                             StragglerSpec, Session)
from repro_torch.configs.spacdc_paper import CONFIG as PAPER
from repro_torch.data.mnist import synthetic_mnist

N_TRAIN, N_TEST = 4096, 1024
SCHEMES = ("conv", "mds", "matdot", "spacdc")


def scheme_spec(scheme, stragglers, k=24):
    t = PAPER.t_colluding if scheme == "spacdc" else 0
    if scheme == "matdot":
        k = 12                         # threshold 2p-1 = 23
    return ClusterSpec(
        code=CodeSpec(scheme=scheme, n_workers=PAPER.n_workers, k_blocks=k),
        privacy=PrivacySpec(t_colluding=t),
        straggler=StragglerSpec(n_stragglers=stragglers), seed=PAPER.seed)


def run_scheme(scheme, xtr, ytr, xte, yte, stragglers, epochs=3,
               device="cuda"):
    with Session(scheme_spec(scheme, stragglers), device=device) as s:
        s.init_mlp((784, 512, 10), lr=PAPER.lr, seed=PAPER.seed)
        # a first round at the backward's shapes, so the virtual clock's
        # per-worker compute time is measured before the timed steps
        s.matmul(s.mlp_weights[1],
                 np.zeros((10, PAPER.batch_size), np.float32), round_idx=0)
        elapsed, curve = 0.0, []
        bs = PAPER.batch_size
        for ep in range(epochs):
            for i in range(0, len(xtr) - bs + 1, bs):
                loss, dt = s.train_step(xtr[i:i + bs], ytr[i:i + bs])
                elapsed += dt
            curve.append((elapsed, s.mlp_accuracy(xte, yte)))
        return curve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stragglers", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the kernels' plain "
                    "versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    xtr, ytr, xte, yte = synthetic_mnist(n_train=N_TRAIN, n_test=N_TEST,
                                         seed=PAPER.seed)
    print(f"N={PAPER.n_workers} T={PAPER.t_colluding} S={args.stragglers}")
    for scheme in SCHEMES:
        curve = run_scheme(scheme, xtr, ytr, xte, yte, args.stragglers,
                           epochs=args.epochs, device=dev)
        t, acc = curve[-1]
        pts = " ".join(f"({t:.2f}s,{a:.3f})" for t, a in curve)
        print(f"{scheme:8s} final acc={acc:.3f} time={t:7.2f}s  curve: {pts}")


if __name__ == "__main__":
    main()
