"""Anytime decoding demo: one straggler-ridden round, every decode point.

Runs a single coded A@B round under a shared straggler trace and prints
the error-vs-latency curve for SPACDC (rateless — decodes at every
arrival) next to MDS (hard threshold), then replays the same round under
the Deadline and ErrorTarget wait policies to show the scheduler actually
acting on the curve.  Everything is configured through the declarative
``ClusterSpec`` → ``Session`` API, on the PyTorch port
(``examples/anytime_decode.py`` is its JAX twin); on the card each curve
is one ``coded_matmul`` and one ``berrut_combine`` launch.

  PYTHONPATH=src python examples/anytime_decode_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec,
                             StragglerSpec, Session, WaitSpec)

N, S = 20, 5
M, D, NOUT = 384, 64, 32


def smooth(m, d, seed=1):
    r = np.random.default_rng(seed)
    t = np.arange(m)[:, None] / m
    out = sum(r.standard_normal(d)[None, :] * np.cos(np.pi * c * t) /
              (1 + c) ** 2.0 for c in range(5))
    return out.astype(np.float32)


def spec_for(scheme, wait=WaitSpec(), **kw):
    return ClusterSpec(
        code=CodeSpec(scheme=scheme, n_workers=N,
                      k_blocks=kw.pop("k_blocks")),
        privacy=PrivacySpec(t_colluding=kw.pop("t_colluding", 0),
                            noise_scale=kw.pop("noise_scale", 1.0)),
        straggler=StragglerSpec(n_stragglers=S), wait=wait, seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the kernels' plain "
                    "versions)")
    dev = torch.device(ap.parse_args(argv).device)
    a = smooth(M, D)
    b = np.random.default_rng(0).standard_normal((D, NOUT)).astype(np.float32)

    print(f"== one round, N={N} workers, {S} stragglers ==")
    for scheme, kw in [("spacdc", dict(k_blocks=5, t_colluding=1,
                                       noise_scale=0.05)),
                       ("mds", dict(k_blocks=12))]:
        with Session(spec_for(scheme, **kw), device=dev) as s:
            pts = s.anytime_curve(a, b, round_idx=0)
            print(f"\n{scheme} (threshold="
                  f"{s.engine.scheme.recovery_threshold}, "
                  f"rateless={s.engine.scheme.rateless}) — "
                  "whole curve in 2 dispatches:")
            for p in pts:
                bar = "-" if not p.ready else f"{p.best_err:.4f}"
                print(f"  after {p.n_responders:2d} arrivals "
                      f"(t={p.t_s * 1e3:7.2f} ms): best err {bar}")

    print("\n== the same round under different wait policies (spacdc) ==")
    for wait in [WaitSpec(),
                 WaitSpec(policy="deadline", t_budget=0.004),
                 WaitSpec(policy="error_target", eps=3e-2)]:
        with Session(spec_for("spacdc", wait=wait, k_blocks=5,
                              t_colluding=1, noise_scale=0.05),
                     device=dev) as s:
            out, st = s.matmul(a, b, round_idx=0)
            out = out.cpu().numpy()
            rel = np.linalg.norm(out - a @ b) / np.linalg.norm(a @ b)
            print(f"  {st.policy:>15}: waited {st.n_waited:2d}/{N} "
                  f"(decode at {st.decode_at_s * 1e3:7.2f} ms virtual)  "
                  f"rel err {rel:.4f}")


if __name__ == "__main__":
    main()
