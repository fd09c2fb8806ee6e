"""Quickstart on the PyTorch port: the whole SPACDC stack behind one
declarative spec, on the card.

A ``ClusterSpec`` names every choice — scheme, privacy, crypto, wait
policy, stragglers, transport — and a ``Session`` runs any workload under
it.  Then the same privacy/crypto internals, hands-on: encode, an
arbitrary non-polynomial f on every worker's shard, decode from whoever
answered.  ``examples/quickstart.py`` is its JAX twin.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec,
                             StragglerSpec, Session, WaitSpec)
from repro_torch.core.privacy import gaussian_mi_bound
from repro_torch.crypto import MEAECC, generate_keypair


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the kernels' plain "
                    "versions)")
    dev = torch.device(ap.parse_args(argv).device)

    # ---- one spec, one session, one coded round --------------------------
    spec = ClusterSpec(
        code=CodeSpec(scheme="spacdc", n_workers=20, k_blocks=4),
        privacy=PrivacySpec(t_colluding=2, noise_scale=0.5),
        straggler=StragglerSpec(n_stragglers=3),
        wait=WaitSpec(policy="deadline", t_budget=0.01),
    )
    rng = np.random.default_rng(0)
    a = rng.standard_normal((240, 64)).astype(np.float32)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    with Session(spec, device=dev) as s:
        out, stats = s.matmul(a, b)
        out = out.cpu().numpy()
        rel = np.linalg.norm(out - a @ b) / np.linalg.norm(a @ b)
        print(f"coded A@B from {stats.n_waited}/20 workers under a "
              f"{spec.wait.t_budget * 1e3:.0f} ms deadline: rel err "
              f"{rel:.4f} (decode at {stats.decode_at_s * 1e3:.2f} ms "
              "virtual)")
        print("spec round-trips:",
              ClusterSpec.from_dict(s.spec.to_dict()) == s.spec)

    # ---- the same machinery, hands-on: encode, lose workers, decode ------
    code = spec.build_scheme()
    X = torch.as_tensor(rng.standard_normal((120, 32)), dtype=torch.float32,
                        device=dev)
    # an arbitrary non-polynomial f (JAX's gelu is the tanh form)
    f = lambda z: F.gelu(z @ z.T, approximate="tanh")
    shards = code.encode(X)                                 # (20, 30, 32)
    print("per-worker privacy bound (bits/elem):",
          float(gaussian_mi_bound(code).max()))

    # ---- MEA-ECC guards each shard in transit (paper §IV) ----------------
    # the runtime's transport configuration: lossless bits codec + static
    # session keys (limb-vectorized pipeline; see README "Security")
    worker_keys = [generate_keypair() for _ in range(3)]
    master_key = generate_keypair()
    mea = MEAECC(mode="stream", codec="bits", device=dev)
    shard0 = shards[0]
    ct = mea.encrypt(shard0, worker_keys[0].pk, sender=master_key, nonce=1)
    assert torch.equal(mea.decrypt(ct, worker_keys[0]), shard0)  # bit-exact
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ct = mea.encrypt(shard0, worker_keys[0].pk, sender=master_key, nonce=2)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_enc = time.perf_counter() - t0
    nbytes = shard0.numel() * shard0.element_size()
    print(f"MEA-ECC shard 0 encrypted bit-exactly "
          f"({nbytes / 1e6 / t_enc:.1f} MB/s)")

    # ---- workers compute; 3 of 20 straggle and never answer --------------
    results = torch.func.vmap(f)(shards)
    responders = np.asarray([0, 1, 2, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15,
                             16, 18, 19])

    # ---- decode from WHOEVER answered — no recovery threshold ------------
    Y = code.decode(results[torch.as_tensor(responders, device=dev)],
                    responders)
    exact = torch.func.vmap(f)(code.split_blocks(X))
    rel = float(torch.sqrt(torch.mean((Y - exact) ** 2)) /
                torch.sqrt(torch.mean(exact ** 2)))
    print(f"decoded from {len(responders)}/20 workers, rel-RMSE = "
          f"{rel:.4f}")


if __name__ == "__main__":
    main()
