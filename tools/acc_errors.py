"""The error of ``SPACDCCode.run`` against the exact f at phase 18's codes
and width, on any device: what phase 18 of ``chip_smoke.py`` prints,
computed without its checks or timings (its prediction was made with it
on a host with no card).  (a) the §V-A example (N=8, K=2, T=1, worker 5
dropped, f(X) = X Xᵀ on X (4096, 3584)); (b) ``paper_fig3()``'s spacdc
without its 7 slowest workers on the SwiGLU hidden, with W's d_ff cut by
``--d-ff`` (phase 18: 18944).  X and W are phase 18's, made from its
seeds by a generator on ``--device`` (a CPU and a card draw different
numbers, so the noise differs too).  Prints max |error| over max |exact|
and the relative RMS error, with every worker and without the dropped.

    PYTHONPATH=src python tools/acc_errors.py --device cpu --d-ff 2048
"""

import argparse
import math
import sys

sys.path.insert(0, ".")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-ff", type=int, default=None,
                    help="(b)'s d_ff (default: phase 18's)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.api import ClusterSpec
    from repro_torch.core.spacdc import SPACDCCode, SPACDCConfig
    dev = torch.device(args.device)
    m, d = cs.ACC_X
    d_ff = args.d_ff or cs.ACC_D_FF
    x = cs.gaussian(torch, dev, cs.ACC_X, cs.ACC_SEED)
    w = [cs.gaussian(torch, dev, (d, d_ff), cs.ACC_SEED + 1 + i) /
         math.sqrt(d) for i in range(2)]
    fns = cs.acc_functions(torch, *w)
    fig3 = ClusterSpec.paper_fig3()
    n3 = fig3.code.n_workers
    delays = fig3.straggler.build(n3, fig3.seed).delays(0)
    slowest = np.argsort(delays, kind="stable")[
        n3 - fig3.straggler.n_stragglers:].tolist()
    for name, code, dropped, fname in (
            ("a", SPACDCCode(SPACDCConfig(**cs.ACC_EXAMPLE)),
             cs.ACC_EXAMPLE_DROPPED, "xxT"),
            ("b", fig3.build_scheme(), slowest, "swiglu")):
        f = fns[fname]
        resp = [i for i in range(code.cfg.n_workers) if i not in dropped]
        noise = code.make_noise((-(-m // code.cfg.k_blocks), d), device=dev)
        exact = torch.func.vmap(f)(code.split_blocks(x))
        print(name, fname, "d_ff" if fname == "swiglu" else "",
              d_ff if fname == "swiglu" else "",
              "without_dropped", cs.acc_errors(
                  torch, code.run(x, f, resp, noise), exact),
              "all_workers", cs.acc_errors(
                  torch, code.run(x, f, None, noise), exact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
