"""How far rwkv6-1.6b's float32 decode moves under rounding-sized changes
of its inputs and of its weights, at random weights, by depth: why
phase 17 (c) of ``chip_smoke.py`` holds the sharded rwkv6 decode within
1e-4 over 8 of 24 layers, and the whole model within twice its own
float32 noise (a mesh reorders every matmul's sums, a change of every op
at rounding size, and at random weights such a change grows with depth).

For each depth: the model from seed 17 (``chip_smoke.P17_SEED``), 4
decode steps of 4 slots from zero states, then the same decode with the
embedding table scaled by (1 + 2^-23 N) (``chip_smoke.jittered_rel``'s
jitter) and with every weight so scaled; prints max |jittered - plain|
over max |plain| for each.  ``--d-model`` cuts the width (heads of 64,
d_ff 3.5 d_model, the vocabulary kept) for a host with no card.

    PYTHONPATH=src python tools/rwkv_conditioning.py [--device cuda]
    PYTHONPATH=src python tools/rwkv_conditioning.py --device cpu \\
        --d-model 1024 --layers 8 24
"""

import argparse
import dataclasses
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 24])
    ap.add_argument("--d-model", type=int, default=None,
                    help="a cut width (a multiple of 64); default the "
                         "config's 2048")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    dev = torch.device(args.device)
    base = get_config("rwkv6-1.6b")
    if args.d_model:
        d = args.d_model
        base = dataclasses.replace(base, d_model=d, n_heads=d // 64,
                                   n_kv_heads=d // 64, d_ff=d * 7 // 2)
    for n in args.layers:
        cfg = dataclasses.replace(base, n_layers=n, compute_dtype="float32")
        model = build_model(cfg, device=dev, seed=17)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (4, 4), generator=gen,
                             device=dev)

        def decode():
            cache, rows = model.init_cache(4, 1), []
            with torch.no_grad():
                for t in range(toks.shape[1]):
                    lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
                    rows.append(lg[:, 0].clone())
            return torch.stack(rows)

        plain = decode()

        def rel(x):
            return float((x - plain).abs().max() / plain.abs().max())

        saved = {k: p.detach().clone() for k, p in model.named_parameters()}
        jitter = torch.Generator(device=dev)
        jitter.manual_seed(99)
        with torch.no_grad():
            table = model.embedding["table"]
            table.mul_(1 + 2.0 ** -23 * torch.randn(
                table.shape, generator=jitter, device=dev))
        embedding = rel(decode())
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(saved[k] * (1 + 2.0 ** -23 * torch.randn(
                    p.shape, generator=jitter, device=dev)))
        every = rel(decode())
        print(f"d_model {cfg.d_model} layers {n}: embedding jitter "
              f"{embedding:.3e}, every weight jitter {every:.3e}",
              flush=True)
        del model, saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
