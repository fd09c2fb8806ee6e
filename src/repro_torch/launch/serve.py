"""Continuous-batching serving entry point — coded by default.

Ports ``repro/launch/serve.py``, with the same flags and output.
Requests arrive on a Poisson timeline and are served by the
continuous-batching scheduler (``repro_torch.runtime.serve_loop``): free
slots admit arrivals at step boundaries, finished requests are evicted and
their slots refilled, and each decode step runs as ONE coded round under a
``Deadline`` wait policy (fixed latency budget, best-effort accuracy).
``--coded-layers`` selects how much of the step is coded — from just the
unembed projection up to every attention/FFN projection (``all``, virtual
transport).  ``--transport threads`` serves the unembed as a real round
per step.  ``--arch`` takes every decoder-only family (the dense GQA
ones, qwen2-vl, deepseek-v2's MLA and MoE, rwkv6 and jamba);
``--arch whisper-small`` raises ``ValueError`` before anything is built,
since the reference's serve loop has no encoder-decoder path.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --tiny \\
      --requests 8 --rate 20 --prompt-len 16 --gen 32 --deadline-ms 8 \\
      --coded-layers all

It runs on the card; ``--device cpu`` runs the plain versions of the
kernels on the CPU.  ``--uncoded`` runs the same continuous-batching loop
with no coded rounds (``coded_layers="none"``) for comparison.
``--report`` prints the session's ``adaptive_report()`` as JSON after the
serve.  ``--transport socket`` serves the unembed as one round per step
over a mesh of worker processes (``python -m repro_torch.launch.worker``,
spawned on the same device as the master).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="alias for --requests (legacy flag)")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests to serve (default 8)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, requests/s on the virtual "
                    "clock (0 = all arrive at t=0)")
    ap.add_argument("--slots", type=int, default=8,
                    help="max in-flight requests (batch slots)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ragged", action="store_true",
                    help="draw ragged per-request prompt lengths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--uncoded", action="store_true",
                    help="continuous batching without coded rounds "
                    "(coded_layers=none)")
    ap.add_argument("--coded-layers", default=None,
                    choices=["none", "unembed", "attn", "ffn", "all"],
                    help="which per-step projections run coded "
                    "(default: all on virtual, unembed on real transports)")
    ap.add_argument("--admission", default="continuous",
                    choices=["continuous", "gated"],
                    help="'gated' reproduces the static-batch baseline")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--k-blocks", type=int, default=4)
    ap.add_argument("--stragglers", type=int, default=2)
    ap.add_argument("--deadline-ms", type=float, default=8.0,
                    help="per-step coded decode budget (virtual ms)")
    from ..runtime.transport import available_backends
    ap.add_argument("--transport", default="virtual",
                    choices=available_backends(),
                    help="round backend (from the transport registry)")
    ap.add_argument("--report", action="store_true",
                    help="after serving, print the session's adaptive/"
                    "health report (Session.adaptive_report) as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "plain versions of the kernels)")
    args = ap.parse_args(argv)
    from ..configs import get_config, tiny_config
    from ..runtime.serve_loop import refuse_encoder_decoder
    refuse_encoder_decoder(tiny_config(args.arch) if args.tiny
                           else get_config(args.arch))

    n_requests = args.requests if args.requests is not None else \
        (args.batch if args.batch is not None else 8)
    if args.coded_layers is not None:
        coded_layers = args.coded_layers
    elif args.uncoded:
        coded_layers = "none"
    else:
        coded_layers = "all" if args.transport == "virtual" else "unembed"

    from ..api import ClusterSpec, Session
    spec = ClusterSpec.serve_deadline(
        t_budget=args.deadline_ms * 1e-3, n_workers=args.workers,
        k_blocks=args.k_blocks, n_stragglers=args.stragglers,
        backend=args.transport, coded_layers=coded_layers,
        max_slots=args.slots)
    with Session(spec, device=args.device) as s:
        rep = s.serve(arch=args.arch, tiny=args.tiny, batch=n_requests,
                      prompt_len=args.prompt_len, gen=args.gen,
                      seed=args.seed, arrival_rate=args.rate,
                      ragged=args.ragged, admission=args.admission)
        session_report = s.adaptive_report() if args.report else None

    label = ("uncoded" if coded_layers == "none" else
             f"coded[{coded_layers}], {spec.code.scheme} "
             f"N={spec.code.n_workers} K={spec.code.k_blocks}")
    print(f"served {len(rep.requests)} requests "
          f"({rep.tokens.shape[0]}x<= {args.gen} tokens, "
          f"{rep.requests_per_s:.1f} req/s virtual, {rep.tok_s:.1f} tok/s "
          f"busy-wall) [{label}, {args.transport} transport, "
          f"{args.admission} admission]")
    print(f"  steps: {len(rep.step_stats)}  "
          f"p50/p99 step {rep.p50_step_s * 1e3:.2f}/"
          f"{rep.p99_step_s * 1e3:.2f} ms  "
          f"compiles {rep.trace_count}  "
          f"coded FLOP fraction {rep.coded_fraction:.2f}")
    if rep.ttft_s.size:
        print(f"  ttft p50/p99 {np.percentile(rep.ttft_s, 50) * 1e3:.2f}/"
              f"{np.percentile(rep.ttft_s, 99) * 1e3:.2f} ms")
    if coded_layers != "none" and rep.step_stats:
        waits = [st.decode_at_s * 1e3 for st in rep.step_stats]
        print(f"  deadline {args.deadline_ms:.1f} ms: "
              f"{rep.steps_within_budget}/{len(rep.step_stats)} steps "
              f"decoded in budget (decode at {min(waits):.2f}-"
              f"{max(waits):.2f} ms, "
              f"argmax agreement {rep.argmax_agreement:.2f})")
    for b in range(min(rep.tokens.shape[0], 2)):
        print(f"  req{b}: {rep.tokens[b][:16].tolist()}...")
    if session_report is not None:
        print(json.dumps(session_report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
