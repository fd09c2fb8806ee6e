#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Thirteen main paths.  Two are SPACDC coded rounds through
``repro_torch.api.Session`` at ``ClusterSpec.paper_fig3()`` (N=30 workers,
K=24 blocks, T=3 noise blocks, S=7 stragglers):

* the plain round, ``Session(spec).matmul(a, b)``: the hand-written CUDA
  kernels ``coded_matmul`` (encode + all N worker products) and
  ``berrut_combine`` (the masked decode);
* the MEA-ECC encrypted round, ``CryptoSpec(encrypt="real")``: the encode
  through ``berrut_combine``, every wire (shards out, results back)
  encrypted and decrypted through the ``mask_add`` kernel, the worker
  products through ``coded_matmul``, the decode through ``berrut_combine``.

The third is the dense decoder LM's full-sequence forward (prefill):
``repro_torch.models.build_model(get_config("qwen2-7b")).forward(tokens)``
at full width (28 layers, d_model 3584, 28 heads over 4 KV heads, d_ff
18944, vocab 152064; float32 weights from a seeded generator, bfloat16
compute) on 1 x 4096 tokens, every attention layer through the ``flash_
attention`` kernel.

The fourth is the paper's own experiment (§VII-B, Fig. 3/4), the SPACDC-DL
trainer (Algorithm 2) of ``examples/spacdc_dl_mnist.py``: ``Session(spec)
.init_mlp((784, 512, 10))`` and one epoch of ``train_step`` under conv,
mds, matdot and spacdc (N=30, S=5; K=24, matdot p=12, spacdc T=3), each
backward product a coded round: the fused round (``coded_matmul`` +
``berrut_combine``) for conv and spacdc, the loop round (``berrut_combine``
encodes and decode around one ``torch.matmul`` per responder) for mds and
matdot; then spacdc on the paper config's 784-512-256-10.

The fifth is the paper's central claim in running form, decoding at any
responder prefix: ``Session(ClusterSpec.anytime_bench()).anytime_curve(a,
b)`` (the error-vs-latency curve) and ``error_target`` rounds, which stop
at the earliest prefix whose embedded-pair error estimate meets ``eps``,
at the qwen2-7b FFN down-projection on a 4096-token prefill (A (4096,
18944) @ B (18944, 3584), N=30, K=6, T=2): one ``coded_matmul`` (encode +
all N worker products) and one ``berrut_combine`` (every prefix's decode
and its Floater–Hormann pair) per round; the same rounds encrypted; and the
``threads`` transport, where every worker's product runs on a thread and a
CUDA stream of its own.

The sixth is coded serving, the server ``python -m
repro_torch.launch.serve`` runs: ``Session(ClusterSpec.serve_deadline())
.serve(arch="qwen2-7b", tiny=False)`` continuously batches requests
through the full-width model (spacdc N=8, K=4, T=1, an 8 ms Deadline);
every decode step is one coded round whose unembed (or, with
``coded_layers="all"``, every projection) runs against weight shards
encoded once by ``berrut_combine`` and is decoded by one ``berrut_combine``
launch per site; ``encrypt="real"`` puts every site's two transfers on the
MEA-ECC wire through ``mask_add``.

The seventh is the straggler and Byzantine story: ``Session(spec).matmul``
under a ``FaultSpec`` (seeded crashes and corruption, screening,
re-dispatch, quarantine) at ``benchmarks/bench_faults.py``'s operating
point and under ``AdaptiveSpec(policy="adaptive")`` at
``benchmarks/bench_adaptive.py``'s, both at the full qwen2-7b FFN width:
the fault round's encode and decode through ``berrut_combine``, its
encrypted wires through ``mask_add``, the adaptive candidates' fused rounds
through ``coded_matmul`` and ``berrut_combine`` at every chosen K.

The eighth is the socket mesh: ``TransportSpec(backend="socket")`` spawns
one OS process per worker (``python -m repro_torch.launch.worker --device
cuda``, each a CUDA context of its own on the card), and work crosses
loopback TCP as CRC-checked frames: the loop round's encode and decode
through ``berrut_combine`` on the master, the sealed wire
(``encrypt="real"``) through ``mask_add`` on the master and in every
worker process, OS-level faults (real SIGKILLs and tampered frames) and
the serve's round mode over the mesh.

The ninth to the eleventh are the model families of later slices, each
forward and coded serving at full width: deepseek-v2's MLA and MoE FFN;
the SSM mixers (rwkv6, jamba); and Qwen2-VL's M-RoPE (qwen2-vl-72b over 8
and 4 of its 80 layers) with whisper-small's encoder-decoder (forward
and decode; the serve loop has no encoder-decoder path).

The twelfth is LM training, the path of ``python -m
repro_torch.launch.train``: phi3-mini-3.8b at full width and depth
through ``launch.steps.build_train_step`` (Berrut-coded gradient
aggregation over 4 blocks, AdamW, per-layer recomputation), every
attention layer's forward through ``flash_attention`` and its backward
through the hand-written ``flash_attention_bwd`` kernel; the entry point
itself with its checkpoint and resume, and an encrypted checkpoint
through ``mask_add``.

The thirteenth is the sharded path: a 2 x 4 (data, model) mesh of 8
gloo ranks over the one card (``launch.mesh.run_ranks``), the models'
parameters DTensors placed by ``param_specs``, the coded train step over
the mesh (each rank's attention through the flash forward and backward
kernels on its local heads, the gradient decoded over ``data`` by
``coded_psum``), the sequence-sharded decode, and the int8 KV cache in a
coded serve through ``berrut_combine``.

Phases, one JSON line each:

1. device and build: the card's name and power limit (``nvidia-smi``), TF32
   off, all five kernel sources built by ``nvcc`` from
   ``src/repro_torch/kernels/csrc``, with ptxas's registers, shared memory
   and spills for every kernel function;
2. each kernel against its plain PyTorch version on the card (float32 and
   bfloat16, ragged shapes and the main path's shapes; ``coded_matmul``'s
   full-width worker 0 x 64 rows also against a float64 product, within 4x
   the plain version's error; ``mask_add`` exactly, at ragged M, the field's
   edge values, broadcast masks and both wires' full M;
   ``berrut_combine`` at the decode of every ``coded_matmul`` case, J =
   200, Q = 40, the full-width encode (30, 27, 1,835,008), the prefix
   decode (720, 30, 2^20), phase 8's prefix decode (360, 30, 2,447,872),
   M = 1,000,003 in both dtypes, a view 4 bytes
   in, and the loop round's calls as the schemes make them at the Fig-3
   backward job (mds K=24 encode and float64-inverted decode, matdot p=12
   encodes of 1-column ``swapaxes`` blocks and its Q = J = 23 decode, the
   polynomial encodes of A and of B's padded transpose and its decode; the
   ill-conditioned decodes held elementwise within float32's error bound
   of the plain version, ``combine_bound_ratio``),
   each row with its load path (TMA or bulk copies), TB/s, device
   time by ``torch.profiler`` (small shapes are host-bound under CUDA
   events) and ptxas line;
   ``flash_attention`` at ragged and unequal Sq, Skv, every head dim it
   pads, hd 20 (whose bf16 rows TMA cannot load), G in {1, 7}, softcap 20,
   causal and full, Skv = 0, MLA's 192/128; float32 on the 3xTF32 route
   with its lse, a second call's bits and its pre-pass's planes; at the
   qwen2-7b prefill shape in float32, the kernel of phase 6 c, and
   bfloat16), no 3xTF32 instantiation spilling, with its time, the plain
   version's time and one
   PyTorch call's time where one computes the same function
   (``library_ms``, a yardstick the port never calls:
   ``scaled_dot_product_attention`` for ``flash_attention``); the two
   tensor-core kernels' rows add their achieved TFLOP/s;
3. the SHA-256 keystream (plain PyTorch) against ``hashlib``, and its time
   at the full-width wire-back;
4. the plain main path: three rounds each of the fig-3 backprop job,
   fig3_wide and the full qwen2-7b FFN up-projection width (12288x3584 @
   3584x18944), each held against the same round through the plain
   versions and against the exact product; every round must launch each
   kernel exactly once;
5. the encrypted main path: three stream-mode rounds of each job, one
   paper-mode and one staged (``crypto.fused=False``) round of fig3_wide,
   with exact launch counts; then, outside the counted window, each round
   against the plain kernel round (same noise and mask, bit-identical),
   and each job's wires: decrypted bits against the sent bits on every
   channel, and the ciphertext limbs of 2 channels against the plain
   ``mask_add``;
6. the model main path: (a) three timed forwards of the full-width
   qwen2-7b, exactly 28 ``flash_attention`` launches each and none of any
   other kernel, then one profiled forward split into the flash kernel,
   matmuls and the rest; (b) the same forward through the plain attention,
   logits within 5e-2 of max |plain| and their argmax agreement; (d) the
   forward's logits of the first 16 tokens against 16 teacher-forced
   ``decode_step`` calls (atol = rtol = 0.05, the reference's own test);
   (c) a 2-layer full-width model in float32 compute, kernel against plain
   to 1e-4; with the peak memory and the phase's time;
7. the training main path: per scheme, 16 ``train_step`` calls counted from
   zero (exact launches per round: conv and spacdc one ``coded_matmul`` and
   one ``berrut_combine``, mds two and matdot three ``berrut_combine``),
   one row each with the path, the median host ms per step between
   synchronizes, the coded round's master ms, the summed virtual
   ``total_s`` and ``compute_wait_s``, the final loss and test accuracy,
   the launches per step, ``n_waited``, the peak memory and one profiled
   step's device time by class; the runs go kernel, plain, plain, kernel
   and the row reports each; checks (a) the same run with the kernels
   forced off (step-1 loss within 1e-5 relative, weights after step 1
   within 1e-5 of max |w| on the fused round, and for the ill-conditioned
   mds and matdot decodes both runs against the float64 step by
   ``f64_rule``; accuracy within 0.02) and every ``berrut_combine`` call
   of one more kernel run elementwise within float32's error bound of the
   plain version on the same inputs, (b) every accuracy >= 0.95, (c)
   conv's summed virtual wait above spacdc's, (d) an mds loop round with
   ``encrypt="real"`` bit-identical to the plain loop round;
8. the anytime and real-thread main path (``anytime_main_path``): (a) the
   curve of rounds 0 and 1 at the full-width job, one launch of each
   kernel per curve, every point ready, ``best_err`` non-increasing, the
   kernels-off curve's workers and times, its errors and proxies within
   1e-4 relative, the prefix decode held elementwise to its plain version,
   the first-ready and first-below-eps points; (b) three ``error_target``
   rounds (eps 5e-2): two launches each, ``n_waited`` < 23, relative error
   against the float64 product < 2 eps, the kernels-off run's stop index
   with the proxies' margins, output within 1e-4 of max |plain|, the
   median ``encode_s`` of three runs, a profiled round's device ms by
   kernel, its idle share and the peak memory; (c) the encrypted
   ``error_target`` rounds at fig3_wide, fused and staged, bit-identical to
   the plain one with exact launches and their ``crypto_s``; (d) the
   ``threads`` transport under ``paper_fig3()`` at fig3_wide, three rounds
   and one under ``Deadline(0.01)``, each within 1e-5 of the plain decode
   of its own responders, its relative error beside the virtual loop
   round's, the loop round's launches, the Deadline round inside its
   budget, the pool closed within ``join_timeout_s``; (e) phase 7's spacdc
   trainer under ``ErrorTarget(0.25)``: one launch of each kernel per
   round, accuracy >= 0.95, the spread of ``n_waited``; with the phase's
   seconds;
9. the serving main path (``serving_main_path``): ``berrut_combine`` at
   the serve's encode and decode shapes against its plain version, with
   ``torch.matmul``'s time and the bound; (a) the full-width, full-depth
   qwen2-7b under ``serve_deadline()`` with ``coded_layers="unembed"``, 8
   requests of prompt 16 and gen 32 arriving at 0, counted from zero (one
   ``berrut_combine`` for the encode and one per step), with tok/s over
   busy wall, step p50/p99 (virtual and wall), TTFT, steps within the
   budget, agreement and peak memory; the same Poisson-ragged with every
   ``berrut_combine`` call held elementwise to its plain version; one
   profiled step's device split and idle share; (b) the exact spec (mds,
   first_k 8) at full width, teacher-forced coded logits against plain
   logits within 2e-2 of max |plain| and no argmax flip outside the near
   ties; (c) ``coded_layers="all"`` at full width over 8 of 28 layers: 33
   launches a step, every call held; (d) ``encrypt="real"`` on (c)'s
   model, tokens bit-identical to the plain wire's with exact ``mask_add``
   launches; (e) the ``threads`` transport's round mode at full width,
   tokens equal to the virtual round mode's, the pool closed within
   ``join_timeout_s``; (f) ``_build.build_count`` still 1.

10. the robust main path (``robust_main_path``): (a) 10 defended and 10
    undefended fault rounds at A (4096, 18944) @ B (18944, 3584), a row
    each (rel-err against float64, retries, exclusions, mask, wait,
    encode / screen / decode seconds); defended worst <= 1e-2, undefended
    worst > 1e-1, retries and quarantines fired, every clean exclusion
    beside a corruption that escaped the norm stage, the kernels-off run
    on the same measured compute time identical, every ``berrut_combine``
    call held, one profiled round; (b) the exclusion proof, plain and
    ``encrypt="real"``, the corrupted set excluded, outputs bit-identical,
    every ``mask_add`` call held; (c) an mds round out of retries raises
    ``DegradedRoundError`` with its results on the card; (d) 48 adaptive
    rounds at A (4096, 3584) @ B (3584, 18944) against the kernels-off
    run (same decisions) and four fixed policies (latency at error beside
    bench_adaptive's 1.1 floor), each candidate's first ``coded_matmul``
    held, no scheme built in the closing third, ``build_count`` 1; (e)
    lcc, glcc (1 and 2 groups), secpoly and bacc loop rounds at fig3_wide
    against float64, every ``berrut_combine`` call held; (f) the health
    snapshot and the adaptive report.

11. the socket main path (``socket_main_path``): (a) three plain and three
    sealed loop rounds under ``paper_fig3()`` at the qwen2-7b q|k|v job A
    (4608, 3584) @ B (3584, 512), 30 worker processes on the card, a row
    each (wall, encode / crypto / decode seconds, wire bytes each way, the
    master's framing seconds, arrival lag behind the virtual clock): each
    bit-identical to the virtual loop round fed its arrival order (round 0
    to real threads too), within 1e-4 of the kernels-off decode of its
    responders, exact master launches, every responder reporting its
    task's launches (two ``mask_add`` sealed, none plain); one held round
    (every ``berrut_combine`` call within float32's bound and, sealed,
    every ``mask_add`` call of the master and the workers exact),
    ciphertext overhead < 256 B, every worker with a CUDA context, no
    live worker written off at the default liveness deadline, mesh
    start, device memory with 30 contexts, a bounded close; (b) OS-level
    faults: (i) bench_transport's SIGKILL point (a real kill, a respawn,
    a retry, the decode bit-identical to the plan simulated on threads),
    (ii) bench_faults' point with drops, two rounds, exclusions, retries
    and decode equal to threads fed the mesh's arrival orders and
    liveness write-offs; (c) phase 9 (e)'s serve over an 8-worker mesh at
    full width (gen cut from 4 to 2), its tokens equal to the first two of
    phase 9 (e)'s threads tokens, step walls and the framing share.  Only the master's launches are counted; the
    workers' happen in their own processes and come back in their
    RESULTs.

12. deepseek-v2-lite-16b at full width and depth (``deepseek_main_path``):
    flash at MLA's 192/128 shape, the forward, coded serving.

13. the SSM mixers (``ssm_main_path``): rwkv6-1.6b at full width and
    depth and jamba at full width over 8 of its 32 layers, each (a, c)
    the forward on 1 x 4096 tokens (the scans' share of a profiled
    forward, jamba's attention through the flash kernel against the plain
    version, the float32 forward against decode) and (b, d) coded serving
    under ``serve_deadline(coded_layers="all")`` (the encrypted step
    bit-identical, a slot reused after an eviction serving as a fresh
    one).

14. M-RoPE and the encoder-decoder (``mrope_encdec_main_path``): (a) the
    flash kernel at whisper's head width 64 (encoder full 4096 x 4096,
    decoder causal 1024 x 1024, cross-attention full 1024 x 4096) and at
    qwen2-vl's GQA 64/8 (causal 4096); (b) qwen2-vl-72b at full width over
    8 of its 80 layers, the forward on 1 x 4096 tokens with the three
    M-RoPE streams of a text-image-text prompt (8 flash launches, float32
    against the kernels-off forward, against 16 decode steps fed the same
    streams); (c) its coded serving over 4 of 80 layers; (d) whisper-small
    at full width and depth, the forward on 4096 frames and 1024 tokens
    (36 flash launches) and 16 decode steps over the encoder output's
    4096 cross rows.

15. LM training (``train_main_path``): (a) ``flash_attention_bwd``
    against its plain version (ragged, both routes' tile edges at 33 to
    257, G 1 and 7, hd 20 on both load routes to 192/128, softcap,
    causal, full and cross, float32 on the 3xTF32 route and bfloat16 on
    the bf16 ``wgmma`` route, the route asserted; lse too), two calls
    bit-identical on either route, ptxas's registers and spills per
    instantiation, timed at the training shape and at MLA's 192/128 in
    both dtypes beside SDPA's backward and the bounds (in float32 the rms
    error against float64 beside the plain float32 version's), and a
    2-layer full-width float32 step's gradients through the kernels (2
    launches on the 3xTF32 route) against the kernels-off step; (b) 6
    coded steps of
    phi3-mini-3.8b at full width and depth on 8 x 4096 tokens (256
    backward calls and 512 forward launches a step), losses, step wall,
    tokens/s, peak memory and a profiled step's split; (c)
    ``launch.train.main`` over 1 of 32 layers killed after its step-2
    checkpoint and re-run, bit-identical to an uninterrupted run; (d) an
    encrypted checkpoint of one layer's attention leaves, every
    ``mask_add`` call held.

16. The sharded path (``sharded_main_path``): which gloo collectives
    serve CUDA tensors; (a) phi3-mini-3.8b at full width over 4 of 32
    layers, tensor parallel on ``model``, a coded shard a data rank: a
    float32 step's gradients and loss against the one-process step's,
    then 3 bf16 coded steps (one dropping a shard) with step wall,
    tokens/s, model FLOP/s, collective seconds and bytes, peak memory a
    rank; (b) qwen2-7b over 4 of 28 layers, 16 float32 decode steps with
    the cache's sequence over ``model``, against the one-process decode;
    (c) phase 9 (c)'s coded serve with the bf16 and the int8 KV cache.
    Phases 6, 15 and 16 also print the model FLOP/s of their timed work
    (``launch.roofline_math``) and its share of the bf16 dense peak.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then non-zero and no result line is printed.  The script imports
nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (see PERF.md), (label, rate): device memory;
# float32 on the CUDA cores; the bf16 dense tensor-core rate for bfloat16
# inputs; a third of the TF32 dense tensor-core rate for float32
# coded_matmul's 3xTF32 split
HBM = ("HBM, 3.35 TB/s", 3.35e12)
F32_CUDA = ("f32 CUDA cores, 67 TFLOP/s", 67e12)
BF16_TC = ("bf16 tensor cores, 989 TFLOP/s", 989e12)
SPLIT_3XTF32 = ("3xTF32 tensor cores, 495/3 TFLOP/s", 495e12 / 3)

# kernel vs plain version, relative to the plain output's max |value|:
# float32 sums run in another order than cuBLAS's (over d up to 3584),
# bfloat16 outputs round once to 8 mantissa bits (2^-8 ~ 3.9e-3)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernel round vs plain round of the main path, relative to max |plain|,
# and the gap between their relative errors against the exact product
ROUND_TOL = 1e-4

FULL = (12288, 3584, 18944)          # qwen2-7b FFN up-projection, 24 x 512 rows
MAIN_SHAPES = [("fig3_backprop", 512, 10, 256), ("fig3_wide", 1536, 256, 512),
               ("qwen2_7b_ffn_up", *FULL)]
# the full-width wires: N = 30 channels of blk = 512 rows, L = 8 limbs
WIRE_OUT_M = 30 * 512 * FULL[1]      # coded shards out, 55,050,240 elements
WIRE_BACK_M = 30 * 512 * FULL[2]     # worker results back, 290,979,840


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(torch, fn, min_total_s: float = 0.3, max_iters: int = 50) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max(time.perf_counter() - t0, 1e-6)
    iters = int(max(3, min(max_iters, min_total_s / est)))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, kernel: str, calls: int = 20):
    """Mean device time in ms of the kernels whose name holds ``kernel``
    over ``calls`` calls of ``fn``, from ``torch.profiler``, after one
    warm-up call: unlike ``timed_ms`` it leaves out the host's time per
    call, which sets ``timed_ms`` for small shapes.  A profile now and
    then records none of a kernel's events (one chip run lost two of three
    names), so it asks up to PROFILE_TRIES times; None when none of them
    recorded such a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def rel_diff(torch, got, want) -> tuple:
    """(max |got - want|, that over max |want|), in float32."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def ptxas_report(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` log -> {mangled kernel symbol: "Used N
    registers, ...; N bytes stack frame, N bytes spill stores, ..."}."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def demangled(report: dict, cu_filt: str) -> dict:
    """The report with its symbols demangled by the toolkit's ``cu++filt``
    without parameter lists, e.g. ``void flash_fwd_wgmma_kernel<2>``."""
    if not report:
        return {}
    names = subprocess.run([cu_filt, "-p", *report], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    assert len(names) == len(report), names
    return dict(zip(names, report.values()))


def bound(nbytes: float, flops: float, rate: tuple) -> dict:
    """The least time for the work: bytes over HBM's rate or operations
    over ``rate`` (label, FLOP/s), whichever is longer, and which it was."""
    t_bytes, t_ops = nbytes / HBM[1], flops / rate[1]
    by_bytes = t_bytes >= t_ops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "bound_rate": HBM[0] if by_bytes else rate[0]}


def build_kernels(torch) -> tuple:
    """TF32 off, then every kernel source built by ``nvcc`` (one process
    per source, all started together).  Returns (build seconds, ptxas's
    report by source), the report read from each library's nvcc log
    whether this process compiled it or found it built.  Phase 9 alone:
    ``serving_main_path(torch, torch.device("cuda"),
    build_kernels(torch)[1]["berrut_combine"])`` with ``src`` on the
    path."""
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library("coded_matmul")
    build_s = time.perf_counter() - t0
    assert _build.build_count == 1, _build.build_count
    cu_filt = str(Path(_build._nvcc()).with_name("cu++filt"))
    return build_s, {stem: demangled(ptxas_report(log), cu_filt)
                     for stem, log in _build.build_log.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import ClusterSpec, Session
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel

    # ---------------------------------------------------- 1. device, build
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda")
    build_s, ptxas = build_kernels(torch)
    emit({"phase": "device_and_build", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_dir": str(_build.BUILD_DIR), "ptxas": ptxas})

    # ---------------------------------- 2. each kernel against its plain twin
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {}
    spacdc = ClusterSpec.paper_fig3().build_scheme()
    dec_w = spacdc.decode_matrix_masked(
        torch.ones(spacdc.n_workers)).to(dev)            # (24, 30)
    cm_cases = [(30, 27, 22, 10, 256, torch.float32),
                (30, 27, 64, 256, 512, torch.float32),
                (30, 27, 22, 10, 256, torch.bfloat16),
                (30, 27, 64, 256, 512, torch.bfloat16),
                (3, 3, 7, 130, 17, torch.float32),
                (3, 3, 7, 130, 17, torch.bfloat16),
                (33, 33, 5, 1000, 3, torch.float32),
                (30, 27, 512, 3584, 18944, torch.float32)]
    for n, j, blk, d, n_out, dt in cm_cases:
        w = randn(n, j)
        a = randn(j, blk, d, dtype=dt)
        b = randn(d, n_out, dtype=dt)
        n0 = coded_matmul_kernel.launches
        got = ops.coded_matmul(w, a, b, force_kernel=True)
        launched = coded_matmul_kernel.launches - n0
        want = ops.coded_matmul(w, a, b, force_kernel=False)
        torch.cuda.synchronize()
        dname = str(dt).split(".")[-1]
        assert launched == 1, launched
        assert got.shape == want.shape and got.dtype == want.dtype
        assert bool(torch.isfinite(got.float()).all())
        err, rel = rel_diff(torch, got, want)
        k_ms = timed_ms(torch, lambda: coded_matmul_kernel(w, a, b))
        p_ms = timed_ms(torch, lambda: ref.coded_matmul(w, a, b))
        lib_ms = (timed_ms(torch, lambda: torch.einsum("nj,jid,dk->nik",
                                                       w, a, b))
                  if dt == torch.float32 else None)
        elt = a.element_size()
        nbytes = 4 * n * j + elt * (j * blk * d + d * n_out + n * blk * n_out)
        flops = 2 * n * j * blk * d + 2 * n * blk * d * n_out
        # float32: the 3xTF32 split's tensor-core rate (the float32 CUDA-core
        # bound beside it); bfloat16 inputs keep bf16's rate
        row = {"phase": "kernel_vs_plain", "kernel": "coded_matmul",
               "shape": {"N": n, "J": j, "blk": blk, "d": d, "n_out": n_out},
               "dtype": dname, "max_abs_err": err, "rel_err": rel,
               "tol": TOL[dname], "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms,
               **bound(nbytes, flops, SPLIT_3XTF32
                       if dt == torch.float32 else BF16_TC),
               "bound_ms_f32_fma": bound(nbytes, flops,
                                                F32_CUDA)["bound_ms"],
               "tflop_per_s": flops / k_ms / 1e9,
               "launches": launched}
        if (blk, d, n_out) == (512, *FULL[1:]):
            # worker 0 x 64 rows against a float64 product: the split's
            # error no worse than 4x the plain float32 version's
            exact = (w[:1].double() @ a[:, :64].reshape(j, -1).double()
                     ).reshape(64, d) @ b.double()
            f64 = {"kernel_max_abs": float((got[0, :64].double() - exact)
                                           .abs().max()),
                   "plain_max_abs": float((want[0, :64].double() - exact)
                                          .abs().max())}
            f64["ratio"] = f64["kernel_max_abs"] / max(f64["plain_max_abs"],
                                                       1e-300)
            row["f64_slice"] = f64
            row["ptxas"] = ptxas["coded_matmul"]
            del exact
        emit(row)
        assert rel <= TOL[dname], row
        if "f64_slice" in row:
            assert row["f64_slice"]["ratio"] <= 4.0, row
        results[("coded_matmul", n, j, blk, d, n_out, dname)] = row

        # the decode of these worker results (the 24 x 30 fig-3 decode when
        # N = 30; N = 33 walks Q = 31 > 24 rows)
        q_w = dec_w if n == 30 else randn(max(n - 2, 1), n)
        results[("berrut_combine", n, blk * n_out, dname)] = check_combine(
            torch, emit, q_w, got.reshape(n, -1), ptxas["berrut_combine"])
        del got, want, a, b
    # a J = 200 slab walk and a Q > 32 chunk walk
    check_combine(torch, emit, randn(8, 200), randn(200, 100003),
                  ptxas["berrut_combine"])
    check_combine(torch, emit, randn(40, 30),
                  randn(30, 5000, dtype=torch.bfloat16),
                  ptxas["berrut_combine"])
    # the full-width encode, the fig-3 prefix decode (30 prefixes x K = 24
    # rows), phase 8's prefix decode (2 x 30 prefixes x K = 6 rows over the
    # full-width job's results), payloads TMA cannot load (M = 3 mod 8; a
    # view 4 bytes in)
    spread = torch.randn(30 * 1000000 + 1, generator=gen, device=dev)
    for name, w, payload in (
            ("encode", randn(30, 27), randn(27, 512 * FULL[1])),
            ("prefix", randn(720, 30), randn(30, 1 << 20)),
            ("prefix_anytime", randn(360, 30),
             randn(30, ANYTIME_BLK * ANYTIME_JOB[2])),
            ("unaligned", dec_w, randn(30, 1000003)),
            ("unaligned", dec_w, randn(30, 1000003, dtype=torch.bfloat16)),
            ("offset_view", dec_w, spread[1:].view(30, 1000000))):
        check_combine(torch, emit, w, payload, ptxas["berrut_combine"],
                      case=name)
    del spread, w, payload
    # the loop round's new shapes: mds K=24 (float64-inverted decode),
    # matdot p=12 (1-column swapaxes blocks, Q = J = 23 decode), the
    # polynomial encode of B's padded transpose
    for case, w, blocks in loop_round_combines(torch, randn):
        check_combine(torch, emit, w, blocks, ptxas["berrut_combine"],
                      case=case, ill_conditioned=case.endswith("decode"))
    torch.cuda.empty_cache()
    mask_rows = check_mask_add(torch, gen, dev)
    torch.cuda.empty_cache()
    flash_row = check_flash(torch, gen, dev, ptxas["flash_attention"])
    torch.cuda.empty_cache()

    # ------------------------------------------------ 3. the keystream
    check_keystream(torch, gen, dev)
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4. plain main path
    spec = ClusterSpec.paper_fig3()
    plain_spec = dataclasses.replace(
        spec, code=dataclasses.replace(spec.code, use_kernel=False))
    berrut_encode_kernel.launches = 0
    coded_matmul_kernel.launches = 0
    mask_add_kernel.launches = 0
    flash_attention_kernel.launches = 0
    for name, m, d, n_out in MAIN_SHAPES:
        a = randn(m, d)
        b = randn(d, n_out)
        exact = torch.matmul(a, b)
        torch.cuda.reset_peak_memory_stats()
        with Session(spec, device="cuda") as sk, \
                Session(plain_spec, device="cuda") as sp:
            for r in range(3):
                c0 = (coded_matmul_kernel.launches,
                      berrut_encode_kernel.launches)
                out_k, st_k = sk.matmul(a, b)
                c1 = (coded_matmul_kernel.launches,
                      berrut_encode_kernel.launches)
                out_p, st_p = sp.matmul(a, b)
                c2 = (coded_matmul_kernel.launches,
                      berrut_encode_kernel.launches)
                assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1), (c0, c1)
                assert c2 == c1, "the plain round launched a kernel"
                assert _build.build_count == 1, _build.build_count
                assert st_k.dispatches == 2 and st_p.dispatches == 0
                assert out_k.shape == (m, n_out) == out_p.shape
                assert out_k.device.type == "cuda"
                assert bool(torch.isfinite(out_k).all())
                assert st_k.n_waited == st_p.n_waited
                assert [w for _, w in st_k.arrivals] == \
                    [w for _, w in st_p.arrivals]
                err, rel = rel_diff(torch, out_k, out_p)
                norm = float(torch.linalg.vector_norm(exact))
                rel_k = float(torch.linalg.vector_norm(out_k - exact)) / norm
                rel_p = float(torch.linalg.vector_norm(out_p - exact)) / norm
                row = {"phase": "main_path", "job": name, "round": r,
                       "A": [m, d], "B": [d, n_out],
                       "kernel_vs_plain_max_abs": err,
                       "kernel_vs_plain_rel": rel,
                       "rel_err_vs_exact_kernel": rel_k,
                       "rel_err_vs_exact_plain": rel_p,
                       "launches": {"coded_matmul": c1[0] - c0[0],
                                    "berrut_combine": c1[1] - c0[1]},
                       "stats_kernel": dataclasses.asdict(st_k),
                       "stats_plain": dataclasses.asdict(st_p),
                       "peak_memory_gb": torch.cuda.max_memory_allocated()
                       / 1e9}
                emit(row)
                assert rel <= ROUND_TOL, row
                assert abs(rel_k - rel_p) <= ROUND_TOL, row
                del out_k, out_p
        del a, b, exact
        torch.cuda.empty_cache()
    launches = {"coded_matmul": coded_matmul_kernel.launches,
                "berrut_combine": berrut_encode_kernel.launches}
    assert launches == {"coded_matmul": 9, "berrut_combine": 9}, launches
    assert mask_add_kernel.launches == 0, "a plain round launched mask_add"

    # -------------------------------------------- 5. encrypted main path
    enc_launches = encrypted_main_path(torch, randn, gen, dev)
    for kname, count in enc_launches.items():
        launches[kname] = launches.get(kname, 0) + count
    assert flash_attention_kernel.launches == 0, "a round launched flash"
    torch.cuda.empty_cache()

    # ------------------------------------------------ 6. model main path
    launches["flash_attention"] = model_main_path(torch, dev)[
        "flash_attention"]

    # --------------------------------------------- 7. training main path
    for kname, count in training_main_path(torch, dev).items():
        launches[kname] += count
    torch.cuda.empty_cache()

    # ---------------------------- 8. anytime and real-thread main path
    for kname, count in anytime_main_path(torch, dev).items():
        launches[kname] += count

    # -------------------------------------- 9. coded serving main path
    serve_tokens = {}
    for kname, count in serving_main_path(
            torch, dev, ptxas["berrut_combine"], keep=serve_tokens).items():
        launches[kname] += count
    torch.cuda.empty_cache()

    # ------------------ 10. fault-tolerant and adaptive rounds, baselines
    for kname, count in robust_main_path(torch, dev).items():
        launches[kname] += count

    # ------------- 11. the socket mesh of worker processes, sealed wire
    for kname, count in socket_main_path(torch, dev, serve_tokens).items():
        launches[kname] += count
    torch.cuda.empty_cache()

    # ------- 12. deepseek-v2-lite-16b: MLA and the MoE FFN at full width
    ds_launches, mla_row = deepseek_main_path(torch, dev)
    for kname, count in ds_launches.items():
        launches[kname] += count

    # --------- 13. the SSM mixers: rwkv6-1.6b and jamba at full width
    ssm_launches, jamba_row = ssm_main_path(torch, dev)
    for kname, count in ssm_launches.items():
        launches[kname] += count

    # ---- 14. M-RoPE (qwen2-vl-72b) and the encoder-decoder (whisper-small)
    p14_launches, p14_flash = mrope_encdec_main_path(torch, dev)
    for kname, count in p14_launches.items():
        launches[kname] += count

    # ------- 15. LM training: phi3-mini-3.8b, the flash backward kernel
    p15_launches, bwd_row = train_main_path(torch, dev)
    launches["flash_attention_bwd"] = 0
    for kname, count in p15_launches.items():
        launches[kname] += count

    # --- 16. the sharded path: a 2 x 4 mesh of gloo ranks on the card
    p16_launches, p16_f32 = sharded_main_path(torch, dev)
    for kname, count in p16_launches.items():
        launches[kname] += count
    F32_FLASH_LAUNCHES["16a_sharded_f32_step"] = p16_f32["flash_f32"]
    bwd_row["float32"]["launches"] += p16_f32["bwd_3xtf32"]
    launches["flash_attention"] += p16_f32["flash_f32"]
    launches["flash_attention_bwd"] += p16_f32["bwd_3xtf32"]

    # --------------------------------------------------------- summary
    n, j, (m, d, n_out) = 30, 27, FULL
    blk = m // 24
    cm = results[("coded_matmul", n, j, blk, d, n_out, "float32")]
    bc = results[("berrut_combine", n, blk * n_out, "float32")]
    kernels = []
    for kname, row, src, repl in (
            ("coded_matmul", cm, "src/repro_torch/kernels/csrc/coded_matmul.cu",
             "src/repro/kernels/coded_matmul.py:71"),
            ("berrut_combine", bc,
             "src/repro_torch/kernels/csrc/berrut_combine.cu",
             "src/repro/kernels/berrut_encode.py:61"),
            ("mask_add", mask_rows[WIRE_BACK_M],
             "src/repro_torch/kernels/csrc/mask_add.cu",
             "src/repro/kernels/mask_add.py:100"),
            ("flash_attention", flash_row,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:84")):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "bound_rate": row["bound_rate"],
                        "library_ms": row["library_ms"]})
    # the backward replaces no TPU kernel: the reference's is XLA.  One
    # entry a route, each at phi3's training shape with MLA's 192/128
    # beside it: the bf16 wgmma route (the phi3 steps of phase 15 b) and
    # the float32 3xTF32 route (the 2-layer float32 step of phase 15 a)
    bwd_keys = ("max_abs_err", "kernel_ms", "kernel_split_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "design_products",
                "design_bound_ms", "tflop_per_s", "bit_identical_second_call")
    for dname, name in (("bfloat16", "flash_attention_bwd"),
                        ("float32", "flash_attention_bwd_3xtf32")):
        main_row = bwd_row[dname]["main"]
        mla = bwd_row[dname]["mla_192_128"]
        n = bwd_row["float32"]["launches"]
        entry = {"name": name, "route": "cuda",
                 "source":
                     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": "none (no TPU kernel; the reference's "
                 "backward is XLA, src/repro/models/attention.py:107)",
                 "launches": (launches["flash_attention_bwd"] - n
                              if dname == "bfloat16" else n),
                 "backward_route": main_row["route"],
                 **{key: main_row[key] for key in bwd_keys},
                 "ms": main_row["kernel_ms"],
                 "bound_rate": main_row["bound_rate"],
                 "mla_192_128": {key: mla[key] for key in bwd_keys}}
        if dname == "float32":
            for key in ("rms_err_vs_float64", "plain_rms_err_vs_float64",
                        "rms_ratio"):
                entry[key] = main_row[key]
                entry["mla_192_128"][key] = mla[key]
        kernels.append(entry)
    # the flash kernel at MLA's widths (phase 12 a), beside its main row,
    # at jamba's GQA shape (phase 13 c) and at whisper's and qwen2-vl's
    # (phase 14 a)
    shapes = (("mla_192_128", mla_row), ("jamba_gqa_128", jamba_row),
              ("whisper_encoder_64", p14_flash["a_whisper_encoder"]),
              ("whisper_decoder_self_64",
               p14_flash["a_whisper_decoder_self"]),
              ("whisper_cross_64", p14_flash["a_whisper_cross"]),
              ("qwen2_vl_gqa_128", p14_flash["a_qwen2_vl"]))
    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library")
    for name, row in shapes:
        kernels[3][name] = {key: row[key] for key in keys}
    # the float32 forward, the 3xTF32 kernel: its main row at MLA's
    # 192/128 (phase 12 a), the other shapes beside it, the CUDA-core
    # bound beside the 3xTF32 one; launches counted by dtype over the
    # float32 model paths (F32_FLASH_LAUNCHES)
    f32 = mla_row["float32"]
    f32_launches = sum(F32_FLASH_LAUNCHES.values())
    entry = {"name": "flash_attention_f32", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:84",
             "launches": f32_launches,
             "launches_by_path": dict(F32_FLASH_LAUNCHES),
             "max_abs_err": f32["max_abs_err"], "ms": f32["kernel_ms"],
             "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
             "bound_by": f32["bound_by"], "bound_rate": f32["bound_rate"],
             "library_ms": f32["library_ms"],
             "bound_f32_fma_ms": f32["bound_f32_fma_ms"],
             "kernel_split_ms": f32["kernel_split_ms"],
             "tflop_per_s": f32["tflop_per_s"],
             "design": "pre-pass (TF32 hi/lo planes of q scale, k, v^T) + "
             "3xTF32 wgmma kernel"}
    for name, row in (("qwen2_7b_128", flash_row),) + shapes[1:]:
        entry[name] = {key: row["float32"][key] for key in
                       keys + ("bound_f32_fma_ms", "kernel_split_ms")}
    kernels.append(entry)
    split = f32["split"]
    kernels.append({"name": "flash_attention_f32_split", "route": "cuda",
                    "source":
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:84 "
                    "(the float32 forward's pre-pass, one a launch)",
                    "launches": f32_launches,
                    "max_abs_err": split["max_abs_err"],
                    "ms": split["ms"], "plain_ms": split["plain_ms"],
                    "bound_ms": split["bound_ms"],
                    "bound_by": split["bound_by"],
                    "bound_rate": split["bound_rate"], "library_ms": None})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def check_combine(torch, emit, w, payload, ptxas: dict,
                  case: str = "decode", ill_conditioned: bool = False) -> dict:
    """berrut_combine kernel vs plain version on one (Q, J) x (J, ...) case
    through ``ops.berrut_combine`` (``w`` may be float64 or numpy and
    ``payload`` a strided view, as a scheme hands them in), with its load
    path, achieved TB/s, device time and its instantiation's ptxas line.
    An ``ill_conditioned`` decode, whose float32 result a max-relative
    tolerance cannot judge, is held elementwise to float32's error bound
    instead (``combine_bound_ratio`` at most 1), and both results to the
    float64 product by ``f64_rule``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.berrut_encode import (berrut_encode_kernel,
                                                   kernel_name, load_path)
    dev = payload.device
    w32 = torch.as_tensor(w).to(device=dev, dtype=torch.float32).contiguous()
    q, j = w32.shape
    flat = payload.reshape(j, -1).contiguous()      # what the kernel reads
    m = flat.shape[1]
    dt = payload.dtype
    dname = str(dt).split(".")[-1]
    n0 = berrut_encode_kernel.launches
    got = ops.berrut_combine(w, payload, force_kernel=True)
    launched = berrut_encode_kernel.launches - n0
    want = ops.berrut_combine(w, payload, force_kernel=False)
    torch.cuda.synchronize()
    assert launched == 1, launched
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all())
    err, rel = rel_diff(torch, got, want)
    k_ms = timed_ms(torch, lambda: berrut_encode_kernel(w32, flat))
    k_dev_ms = device_ms(torch, lambda: berrut_encode_kernel(w32, flat),
                         "berrut_stream_kernel")
    p_ms = timed_ms(torch, lambda: ref.berrut_combine(w32, flat))
    lib_ms = (timed_ms(torch, lambda: torch.matmul(w32, flat))
              if dt == torch.float32 else None)
    elt = payload.element_size()
    nbytes = 4 * q * j + elt * (j * m + q * m)
    kname = kernel_name(q, flat)
    lines = [v for k, v in ptxas.items() if kname in k]
    assert len(lines) == 1, (kname, list(ptxas))
    row = {"phase": "kernel_vs_plain", "kernel": "berrut_combine",
           "case": case, "shape": {"Q": q, "J": j, "M": m}, "dtype": dname,
           "payload": {"shape": list(payload.shape),
                       "strides": list(payload.stride()),
                       "contiguous": payload.is_contiguous()},
           "loads": load_path(flat),
           "max_abs_err": err, "rel_err": rel, "tol": TOL[dname],
           "kernel_ms": k_ms, "kernel_device_ms": k_dev_ms,
           "plain_ms": p_ms, "library_ms": lib_ms,
           **bound(nbytes, 2 * q * j * m,
                   F32_CUDA if dt == torch.float32 else BF16_TC),
           "tb_per_s": nbytes / k_ms / 1e9, "launches": launched,
           "ptxas": {kname: lines[0]}}
    if ill_conditioned:
        row["bound_ratio"] = combine_bound_ratio(torch, w, payload, got,
                                                 want)
        row["f64"] = f64_rule(torch, got, want,
                              (w32.double() @ flat.double()).reshape(
                                  got.shape))
    emit(row)
    if ill_conditioned:
        assert row["bound_ratio"] <= 1.0, row
        assert row["f64"]["holds"], row
    else:
        assert rel <= TOL[dname], row
    return row


# the berrut_combine calls of one loop round per scheme at the Fig-3
# backward job, in the order each scheme makes them
LOOP_COMBINES = {"mds": ("mds_k24_encode", "mds_k24_decode"),
                 "matdot": ("matdot_p12_encode_a_swapaxes",
                            "matdot_p12_encode_b", "matdot_p12_decode"),
                 "polynomial": ("polynomial_encode_a",
                                "polynomial_encode_b_padded_transpose",
                                "polynomial_decode")}


def loop_round_combines(torch, randn) -> list:
    """[(case, weights, blocks)]: the ``berrut_combine`` calls of one loop
    round each of mds (K=24), matdot (p=12) and polynomial (p=24, q=1) at
    the Fig-3 backward job A(512,10) @ B(10,256), N=30, S=5, recorded from
    the schemes as the engine drives them (float64 weights, strided
    views)."""
    from repro_torch.api import ClusterSpec, Session
    a, b = randn(512, 10), randn(10, 256)
    calls = []
    for scheme, k in (("mds", 24), ("matdot", 12), ("polynomial", 24)):
        spec = ClusterSpec.from_legacy_kwargs(scheme, 30, k, n_stragglers=5)
        with Session(spec, device="cuda") as s:
            assert not s.engine.use_fused
            sch = s.engine.scheme
            names = iter(LOOP_COMBINES[scheme])

            def record(w, blocks, _orig=sch._combine, _names=names):
                calls.append((next(_names), w, blocks))
                return _orig(w, blocks)
            sch._combine = record
            s.matmul(a, b)
    assert [c[0] for c in calls] == [n for v in LOOP_COMBINES.values()
                                     for n in v]
    return calls


# flash_attention cases, (B, Sq, Skv, H, KV, hd, causal, softcap[, hd_v]):
# ragged and unequal Sq, Skv, every head dim the kernels pad, G in {1, 7},
# softcap, Skv = 0, MLA's 192/128 under GQA
FLASH_CASES = [(1, 65, 130, 2, 2, 48, False, 0.0),
               (1, 65, 130, 2, 2, 48, True, 0.0),
               (2, 130, 65, 14, 2, 96, True, 0.0),
               (1, 256, 256, 4, 4, 128, False, 0.0),
               (1, 300, 300, 8, 2, 64, True, 20.0),
               (1, 100, 0, 4, 2, 64, True, 0.0),
               (1, 150, 90, 8, 2, 192, True, 20.0, 128),
               (2, 90, 170, 6, 3, 96, False, 20.0)] + \
    [(2, 200, 200, 7, 1, hd, True, 0.0)
     for hd in (16, 20, 32, 48, 64, 96, 128)]
# float32 q, k and v as views into rows 4 elements wider: the pre-pass
# reads them through their strides
FLASH_F32_VIEWS = [(2, 200, 200, 7, 1, 20, True, 0.0),
                   (1, 130, 130, 3, 3, 192, True, 0.0, 128)]
# qwen2-7b prefill: B = 1, S = 4096, H = 28, KV = 4, hd = 128, causal
FLASH_MAIN = (1, 4096, 4096, 28, 4, 128, True, 0.0)
MODEL_TOKENS = 4096
# forward logits, kernel against plain: bfloat16 compute (28 layers of
# bfloat16 activations) and float32 compute (2 layers), of max |plain|
LOGIT_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# the float32 flash forward's launches by model path (phases 6 c, 12 b, 13
# c, 14 b and d, 15 a), from ``flash_attention_kernel.launches_by_dtype``
F32_FLASH_LAUNCHES: dict = {}


def f32_flash_launches() -> int:
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    return flash_attention_kernel.launches_by_dtype["float32"]


def flash_work(b, sq, skv, h, kv, hd, causal, elt, hd_v=None) -> tuple:
    """(bytes, FLOP) of one attention forward: q, k, v read and out written
    once; both products (q . k over hd, P . v over hd_v, which defaults to
    hd) over the (query, key) pairs the mask keeps."""
    hd_v = hd if hd_v is None else hd_v
    pairs = sum(min(skv, i + 1) for i in range(sq)) if causal else sq * skv
    return (elt * (b * sq * h * (hd + hd_v) + b * skv * kv * (hd + hd_v)),
            2 * b * h * (hd + hd_v) * pairs)


def check_flash(torch, gen, dev, ptxas: dict) -> dict:
    """flash_attention kernel vs ``ref.mha_reference`` over FLASH_CASES in
    float32 (``check_f32_flash``: the 3xTF32 route, its lse and a second
    call's bits, its pre-pass's planes; FLASH_F32_VIEWS too) and bfloat16,
    then at the qwen2-7b prefill shape in float32 (the kernel of phase 6's
    2-layer float32 check) and bfloat16, each timed beside the plain
    version and ``scaled_dot_product_attention``; no instantiation of the
    3xTF32 kernel may spill.  Returns the bfloat16 main row, which carries
    the kernel's ptxas report, the float32 main row under its "float32"."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     load_width)

    def inputs(case, dt, pad=0):
        b, sq, skv, h, kv, hd = case[:6]
        hd_v = case[8] if len(case) > 8 else hd
        return tuple(torch.randn(shape[:3] + (shape[3] + pad,),
                                 generator=gen, device=dev).to(dt)
                     [..., :shape[3]]
                     for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                                   (b, skv, kv, hd_v)))

    def shape_of(case):
        return dict(zip(("B", "Sq", "Skv", "H", "KV", "hd", "causal",
                         "softcap", "hd_v"), case))

    f32_kernels = {sym: line for sym, line in ptxas.items()
                   if "flash_fwd_3xtf32_kernel" in sym}
    assert len(f32_kernels) == 5, list(ptxas)
    assert all(spills(line) == 0 for line in f32_kernels.values()), \
        f32_kernels
    worst = {}
    f32_main = None
    runs = [(case, torch.float32, True) for case in FLASH_F32_VIEWS]
    runs += [(case, dt, False) for case in FLASH_CASES + [FLASH_MAIN]
             for dt in (torch.float32, torch.bfloat16)]
    for case, dt, view in runs:
        dname = str(dt).split(".")[-1]
        causal, softcap = case[6], case[7]
        q, k, v = inputs(case, dt, pad=4 if view else 0)
        if dt == torch.float32:
            row = check_f32_flash(
                torch, q, k, v, causal,
                {"phase": "kernel_vs_plain", "kernel": "flash_attention",
                 "shape": shape_of(case), "dtype": dname,
                 "strided_views": view},
                softcap=softcap, timed=case is FLASH_MAIN)
            worst[dname] = max(worst.get(dname, 0.0), row["rel_err"])
            if case is FLASH_MAIN:
                f32_main = row
            del q, k, v
            continue
        n0 = flash_attention_kernel.launches
        got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
        launched = flash_attention_kernel.launches - n0
        want = ref.mha_reference(q, k, v, causal=causal, softcap=softcap)
        torch.cuda.synchronize()
        assert launched == 1, launched
        assert got.shape == want.shape and got.dtype == want.dtype
        assert bool(torch.isfinite(got.float()).all())
        err, rel = rel_diff(torch, got, want)
        width = load_width(q, k, v)
        row = {"phase": "kernel_vs_plain", "kernel": "flash_attention",
               "shape": shape_of(case), "dtype": dname, "max_abs_err": err,
               "rel_err": rel, "tol": TOL[dname], "launches": launched,
               "loads": "tma" if width == 16 else f"plain {width}-byte"}
        worst[dname] = max(worst.get(dname, 0.0), rel)
        if case is not FLASH_MAIN:
            emit(row)
            assert rel <= TOL[dname], row
            continue
        # the main shape: the forward's (phase 6 a)
        row.update(flash_timing(torch, q, k, v, causal))
        nbytes, flops = flash_work(*case[:7], q.element_size())
        row.update(**bound(nbytes, flops, BF16_TC), flop=flops,
                   bytes=nbytes, tflop_per_s=flops / row["kernel_ms"] / 1e9,
                   worst_rel_err_by_dtype=worst, ptxas=ptxas,
                   float32=f32_main)
        emit(row)
        assert rel <= TOL[dname], row
        del q, k, v, got, want
        torch.cuda.empty_cache()
        return row


def model_main_path(torch, dev) -> dict:
    """Phase 6: the full-width qwen2-7b forward, counted from zero, then its
    checks outside the count.  Returns the kernel launches of (a)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.models import build_model
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}

    def counts() -> dict:
        return {k: f.launches for k, f in kernels.items()}

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)                   # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = cfg.n_layers
    want_launch = {"coded_matmul": 0, "berrut_combine": 0, "mask_add": 0,
                   "flash_attention": n_layers}

    # ---- (a) the main path: three forwards through the kernel
    for f in kernels.values():
        f.launches = 0
    forward_s = []
    with torch.inference_mode():
        for r in range(3):
            c0 = counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, aux = model(tokens)
            torch.cuda.synchronize()
            forward_s.append(time.perf_counter() - t)
            c1 = counts()
            got = {k: c1[k] - c0[k] for k in kernels}
            assert got == want_launch, (r, got)
        launches = counts()
    assert launches["flash_attention"] == 3 * n_layers, launches
    assert tuple(logits.shape) == (1, MODEL_TOKENS, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    forward_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with torch.inference_mode():
        try:
            breakdown = profile_device(torch, lambda: model(tokens),
                                       FORWARD_CLASSES)
        except Exception as exc:          # a measurement, not a check
            breakdown = {"profiler_error": repr(exc)}
        # the per-use weight casts alone: every weight the forward casts
        cast = [p for n, p in model.named_parameters()
                if p.dim() > 1 and n != "embedding.table"]
        breakdown["weight_casts_alone_ms"] = timed_ms(
            torch, lambda: [p.to(torch.bfloat16) for p in cast],
            max_iters=5)
        # the forward's matmul work: q, k, v, o and the swiglu FFN per
        # layer, and the unembedding, over every token
        hd = cfg.head_dim_
        per_layer = 2 * cfg.d_model * hd * (cfg.n_heads + cfg.n_kv_heads) + \
            3 * cfg.d_model * cfg.d_ff
        mm_flop = 2 * MODEL_TOKENS * (n_layers * per_layer +
                                      cfg.d_model * cfg.vocab_size)
        mm_ms = breakdown.get("device_ms_by_class", {}).get("matmul")
        breakdown["matmul_flop"] = mm_flop
        breakdown["matmul_tflop_per_s"] = (mm_flop / mm_ms / 1e9
                                           if mm_ms else None)

        # ---- (b) the same forward through the plain attention
        c0 = counts()
        plain, _ = model(tokens, force_kernel=False)
        torch.cuda.synchronize()
        assert counts() == c0, "the plain forward launched a kernel"
        err_b, rel_b = rel_diff(torch, logits, plain)
        argmax_agree = float((logits.argmax(-1) == plain.argmax(-1))
                             .float().mean())
        plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del plain

        # forward against decode in bfloat16 compute: reported, not held
        err_d_bf16, excess_d_bf16 = forward_vs_decode(torch, model, tokens)
    del logits, model
    torch.cuda.empty_cache()

    # ---- (d) forward against teacher-forced decode, first 16 tokens: the
    # same seeded weights in float32 compute, as the reference's own test
    # (tests/test_models.py) holds the contract
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        seed=0)
    with torch.inference_mode():
        err_d, excess_d = forward_vs_decode(torch, model, tokens)
    del model
    torch.cuda.empty_cache()

    # ---- (c) 2 full-width layers in float32 compute, kernel vs plain
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model2 = build_model(cfg2, seed=0)
    with torch.inference_mode():
        c0 = counts()
        f0 = f32_flash_launches()
        got2, _ = model2(tokens)
        F32_FLASH_LAUNCHES["6c_qwen2_7b"] = f32_flash_launches() - f0
        assert counts()["flash_attention"] - c0["flash_attention"] == 2
        assert F32_FLASH_LAUNCHES["6c_qwen2_7b"] == 2
        want2, _ = model2(tokens, force_kernel=False)
        torch.cuda.synchronize()
    err_c, rel_c = rel_diff(torch, got2, want2)
    del got2, want2, model2
    torch.cuda.empty_cache()

    row = {"phase": "model_main_path", "arch": cfg.name,
           "tokens": [1, MODEL_TOKENS], "params": n_params,
           "layers": n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "compute_dtype": cfg.compute_dtype,
           "build_s": build_s, "forward_s": forward_s,
           "launches_per_forward": want_launch, "launches": launches,
           "breakdown": breakdown,
           "b_kernel_vs_plain_max_abs": err_b,
           "b_kernel_vs_plain_rel": rel_b, "b_tol": LOGIT_TOL["bfloat16"],
           "b_argmax_agreement": argmax_agree,
           "c_f32_2_layers_max_abs": err_c, "c_f32_2_layers_rel": rel_c,
           "c_tol": LOGIT_TOL["float32"],
           "d_forward_vs_decode_max_abs": err_d,
           "d_excess_over_atol_rtol_0.05": excess_d,
           "d_compute_dtype": "float32",
           "bf16_forward_vs_decode_max_abs": err_d_bf16,
           "bf16_excess_over_atol_rtol_0.05": excess_d_bf16,
           "peak_memory_gb": {"forward": forward_peak_gb,
                              "with_plain_forward": plain_peak_gb},
           "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    model_flops_row("model_main_path", cfg, MODEL_TOKENS, 1, "prefill",
                    sorted(forward_s)[len(forward_s) // 2])
    assert rel_b <= LOGIT_TOL["bfloat16"], row
    assert rel_c <= LOGIT_TOL["float32"], row
    assert excess_d <= 0.0, row
    return launches


def forward_and_decode(torch, model, tokens, n: int, mrope=None) -> tuple:
    """(the forward's float32 logits on the first n tokens, those of n
    teacher-forced ``decode_step`` calls); ``mrope`` (3, 1, >= n) M-RoPE
    streams, sliced for the forward and fed (3, 1, 1) to each step."""
    full, _ = model(tokens[:, :n], mrope_positions=None if mrope is None
                    else mrope[:, :, :n])
    cache = model.init_cache(1, n)
    steps = []
    for t in range(n):
        step, cache = model.decode_step(
            cache, tokens[:, t:t + 1], t, mrope_positions=None
            if mrope is None else mrope[:, :, t:t + 1])
        steps.append(step[:, 0])
    return full.float(), torch.stack(steps, dim=1).float()


def forward_vs_decode(torch, model, tokens, n: int = 16) -> tuple:
    """The forward's logits on the first n tokens against n teacher-forced
    ``decode_step`` calls: (max |diff|, max of |diff| - (0.05 + 0.05 *
    |forward|)), which is <= 0 when they agree to atol = rtol = 0.05."""
    full, inc = forward_and_decode(torch, model, tokens, n)
    diff = (inc - full).abs()
    return float(diff.max()), float((diff - (0.05 + 0.05 * full.abs())).max())


# device kernel classes of a profile, (class, name substrings), first match
# wins, the rest is "other": the forward's (phase 6) and a training step's
# (phase 7: coded_matmul is three kernels)
FORWARD_CLASSES = (("flash_attention", ("flash_fwd",)),
                   ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                   ("casts", ("copy_kernel",)))   # dtype casts, layout copies
# a device activity between two marker kernels (``torch.cuda._sleep(0)``'s
# spin kernel, launched around each ``chunked_scan`` of the SSM mixers by
# ``annotate_scans``) is "scan" whatever its class
SCAN_MARKER = "spin_kernel"
# the profile's ends: HEADS marker kernels spinning HEAD_CYCLES (~0.1 ms
# each at the H100's 1.98 GHz) are launched before the profiled call and
# one spinning TAIL_CYCLES (~2 ms) after it; the profile reads what lies
# between the last head seen and the tail.  A trace without the tail lost
# its end, and one whose scan markers disagree with the host's count of
# scans lost some of its middle or start: either is taken again, at most
# PROFILE_TRIES times.  A profiler session drops the first milliseconds of
# device activity when the tracer has been idle (1-35 ms seen, PERF.md
# §6), so a throw-away session of HEADS spins runs just before the
# recorded one, and ``heads_seen`` reports how many of the recorded
# heads survived (all lost: the call's first activities may be too).
# The window stays open PROFILE_PAD_S past the tail
HEADS = 16
HEAD_CYCLES, TAIL_CYCLES = 200_000, 4_000_000
HEAD_MIN_NS, TAIL_MIN_NS = 50_000, 1_500_000
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.2
STEP_CLASSES = (("berrut_combine", ("berrut_stream",)),
                ("coded_matmul", ("encode_split_kernel", "split_b_kernel",
                                  "gemm_3xtf32_kernel")),
                ("mask_add", ("mask_add",)),
                ("cublas", ("gemm", "xmma", "cutlass", "nvjet")))


def spins(torch, n: int, cycles: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def profile_device(torch, fn, classes, scans=None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time by class
    (an activity between an odd and the next ``SCAN_MARKER`` kernel is
    "scan", the rest go by ``classes``' names), the count of device
    activities less the markers (kernels, copies and sets: the launches),
    the top kernels, and the device's idle share of the span from the
    first activity's start to the last one's end and of the host's wall
    from the call to the device's end of it.  It records device
    activities only and reads the profiler's raw events: an SSM forward
    launches ~4 x 10^5 kernels, host op events would add ~4 per launch,
    and the Python event list costs ~66 us an event to build.  The call
    is bracketed by end markers (``HEADS``, ``TAIL_CYCLES``); a trace
    without the tail, or with scan markers other than twice the host's
    count of scans during the call (``scans``: that count so far, from
    ``annotate_scans``), is taken again; ``profile_tries`` says how many
    calls it took.  Outside the counted main paths."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            spins(torch, HEADS, HEAD_CYCLES)      # wakes the tracer
        n0 = scans() if scans else 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spins(torch, HEADS, HEAD_CYCLES)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            spins(torch, 1, TAIL_CYCLES)
            time.sleep(PROFILE_PAD_S)
        host_scans = scans() - n0 if scans else None
        device = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA),
                        key=lambda e: e.start_ns())
        ends = [(i, e.duration_ns() >= TAIL_MIN_NS)
                for i, e in enumerate(device)
                if SCAN_MARKER in e.name()
                and e.duration_ns() >= HEAD_MIN_NS]
        heads = [i for i, tail in ends if not tail]
        tails = [i for i, tail in ends if tail]
        whole = len(tails) == 1 and all(i < tails[0] for i in heads)
        if whole:
            start = heads[-1] + 1 if heads else 0
            device = device[start:tails[0]]
            n_markers = sum(SCAN_MARKER in e.name() for e in device)
            whole = host_scans is None or n_markers == 2 * host_scans
        if whole:
            break
        emit({"phase": "profile_device", "check": "activities_lost",
              "try": tries, "activities": len(device),
              "heads_seen": len(heads), "tails_seen": len(tails),
              "host_scans": host_scans,
              "first": [e.name()[:60] for e in device[:3]],
              "last": [e.name()[:60] for e in device[-3:]]})
    assert whole, f"the profiler lost activities {PROFILE_TRIES} times"
    by_class = {"scan": 0.0, **{key: 0.0 for key, _ in classes},
                "other": 0.0}
    launches = dict.fromkeys(by_class, 0)
    top = {}
    markers, in_scan = 0, False
    first, last = float("inf"), float("-inf")
    for e in device:
        name = e.name()
        if SCAN_MARKER in name:
            markers += 1
            in_scan = not in_scan
            continue
        ms = e.duration_ns() / 1e6
        first, last = min(first, e.start_ns()), max(last, e.end_ns())
        low = name.lower()
        key = "scan" if in_scan else next(
            (k for k, subs in classes if any(w in low for w in subs)),
            "other")
        by_class[key] += ms
        launches[key] += 1
        top[name[:90]] = top.get(name[:90], 0.0) + ms
    busy = sum(by_class.values())
    span_ms = (last - first) / 1e6 if busy else 0.0
    return {"device_ms_by_class": by_class, "launches_by_class": launches,
            "launches": sum(launches.values()), "scan_calls": markers // 2,
            "profile_tries": tries, "heads_seen": [len(heads), HEADS],
            "host_scan_calls": host_scans,
            "device_busy_ms": busy, "device_span_ms": span_ms,
            "profiled_wall_ms": wall_ms,
            "idle_share_of_span": 1.0 - busy / span_ms if busy else None,
            "idle_share_of_wall": 1.0 - busy / wall_ms,
            "top_kernels_ms": dict(sorted(top.items(),
                                          key=lambda kv: -kv[1])[:8])}


def q_limbs_secp256k1():
    from repro_torch.crypto import CURVE_SECP256K1, field
    q = CURVE_SECP256K1.q
    return q, tuple(int(v) for v in field.int_to_limbs(q, 8))


def rand_limbs(torch, gen, dev, shape):
    """Random 32-bit limbs as torch.uint32.  With 8 limbs each row is a
    secp256k1 field element: a random 256-bit value is >= q with
    probability ~2^-224."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device=dev, generator=gen).view(torch.uint32)


def check_mask_add(torch, gen, dev) -> dict:
    """mask_add kernel vs its plain version, exactly: ragged M, the field's
    edge values, broadcast masks, and both wires' full-width M (timed).
    Returns the full-width rows by M."""
    from repro_torch.crypto import field
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mask_add import mask_add_kernel
    q, ql = q_limbs_secp256k1()

    def same(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    for m in (1, 100, 513, 4096):
        a = rand_limbs(torch, gen, dev, (m, 8))
        b = rand_limbs(torch, gen, dev, (m, 8))
        for sub in (False, True):
            n0 = mask_add_kernel.launches
            got = ops.mask_add(a, b, q, subtract=sub)
            assert mask_add_kernel.launches == n0 + 1
            assert same(got, ops.mask_add(a, b, q, subtract=sub,
                                          force_kernel=False)), (m, sub)
    vals = [0, 1, 2, q - 1, q - 2, (1 << 255) % q, 0xFFFFFFFF,
            0xFFFFFFFF00000000 % q]
    a = field.as_u32_tensor([field.int_to_limbs(v, 8) for v in vals], dev)
    for other in (0, 1, q - 1):
        b = field.as_u32_tensor(field.int_to_limbs(other, 8), dev)
        for sub in (False, True):
            got = ops.mask_add(a, b, q, subtract=sub)
            assert same(got, ref.mask_add(a, b, ql, subtract=sub))
            for g, x in zip(field.limbs_to_int(got.cpu().numpy()), vals):
                assert int(g) == ((x - other) if sub else (x + other)) % q
    # one mask row per channel (paper mode's Ψ) and one for everything
    a = rand_limbs(torch, gen, dev, (3, 700, 8))
    for mask in (rand_limbs(torch, gen, dev, (3, 1, 8)),
                 rand_limbs(torch, gen, dev, (8,))):
        for sub in (False, True):
            assert same(ops.mask_add(a, mask, q, subtract=sub),
                        ref.mask_add(a, mask, ql, subtract=sub))
    emit({"phase": "kernel_vs_plain", "kernel": "mask_add",
          "cases": "M in (1, 100, 513, 4096), edge values, broadcast masks",
          "exact": True})

    rows = {}
    chunk = 1 << 24
    for m in (WIRE_OUT_M, WIRE_BACK_M):
        a = rand_limbs(torch, gen, dev, (m, 8))
        b = rand_limbs(torch, gen, dev, (m, 8))
        row = {"phase": "kernel_vs_plain", "kernel": "mask_add",
               "shape": {"M": m, "L": 8}, "dtype": "uint32"}
        for sub in (False, True):
            got = mask_add_kernel(a, b, ql, subtract=sub)
            err = 0
            plain_events = []
            for s0 in range(0, m, chunk):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                want = ref.mask_add(a[s0:s0 + chunk], b[s0:s0 + chunk], ql,
                                    subtract=sub)
                stop.record()
                plain_events.append((start, stop))
                diff = (field.to_i64(got[s0:s0 + chunk]) -
                        field.to_i64(want)).abs().max()
                err = max(err, int(diff))
                del want
            torch.cuda.synchronize()
            p_ms = sum(e0.elapsed_time(e1) for e0, e1 in plain_events)
            del got
            k_ms = timed_ms(torch, lambda: mask_add_kernel(a, b, ql,
                                                           subtract=sub))
            nbytes = 3 * m * 8 * 4       # payload and mask read, out written
            key = "subtract" if sub else "add"
            row[key] = {"max_abs_err": float(err), "kernel_ms": k_ms,
                        "plain_ms": p_ms, **bound(nbytes, 0, HBM)}
            assert err == 0, row
        emit(row)
        rows[m] = {"max_abs_err": max(row["add"]["max_abs_err"],
                                      row["subtract"]["max_abs_err"]),
                   "kernel_ms": row["add"]["kernel_ms"],
                   "plain_ms": row["add"]["plain_ms"],
                   "bound_ms": row["add"]["bound_ms"],
                   "bound_by": row["add"]["bound_by"],
                   "bound_rate": row["add"]["bound_rate"],
                   "library_ms": None}
        del a, b
        torch.cuda.empty_cache()
    return rows


def check_keystream(torch, gen, dev) -> None:
    """The SHA-256 counter keystream on the card against hashlib (partial
    blocks, lane-chunk edges), then its time at the full-width wire-back
    (30 channels x 9,699,328 words) for three lane chunks."""
    import hashlib
    from repro_torch.crypto import field
    seeds = rand_limbs(torch, gen, dev, (3, 8))
    host = field.to_i64(seeds).cpu().tolist()
    for n_words, chunk in ((1, 5), (9, 5), (4097, 1000)):
        lo, hi = field.keystream_words_traced_batched(seeds, n_words,
                                                      lane_chunk=chunk)
        lo, hi = field.to_i64(lo).cpu().tolist(), field.to_i64(hi).cpu().tolist()
        for c in range(3):
            seed = b"".join(w.to_bytes(4, "big") for w in host[c])
            words = []
            for ctr in range(-(-n_words // 4)):
                dig = hashlib.sha256(seed + ctr.to_bytes(8, "big")).digest()
                words += [int.from_bytes(dig[i:i + 8], "big")
                          for i in range(0, 32, 8)]
            got = [(h << 32) | l for l, h in zip(lo[c], hi[c])]
            assert got == words[:n_words], (n_words, c)
    seeds = rand_limbs(torch, gen, dev, (30, 8))
    n_words = WIRE_BACK_M // 30
    times = {}
    for chunk in (1 << 20, field.LANE_CHUNK, 1 << 22):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = field.keystream_words_traced_batched(seeds, n_words,
                                                   lane_chunk=chunk)
        torch.cuda.synchronize()
        times[str(chunk)] = (time.perf_counter() - t0) * 1e3
        del out
    emit({"phase": "keystream", "vs_hashlib": "exact",
          "full_width_wire_back": {"channels": 30, "words": n_words,
                                   "counter_blocks": 30 * (n_words // 4)},
          "ms_by_lane_chunk": times, "default_lane_chunk": field.LANE_CHUNK})


def check_wires(torch, gen, dev, a, b, mode: str) -> dict:
    """One job's wires through the kernel, outside the counted main path:
    the sent shards and results come back bit for bit on every channel,
    and the ciphertext limbs of channels 0 and 1 equal the plain
    ``mask_add`` of the same embed and mask."""
    from repro_torch.api import ClusterSpec
    from repro_torch.crypto import field
    from repro_torch.kernels import encrypted_round as er, ops, ref
    q, ql = q_limbs_secp256k1()
    scheme = ClusterSpec.paper_fig3().build_scheme()
    enc = scheme.fused_encoder_matrix().to(dev)
    sent = ops.berrut_combine(enc, scheme.fused_blocks(a))
    n = sent.shape[0]
    checks = {}
    for direction in ("out", "back"):
        if mode == "stream":
            material = rand_limbs(torch, gen, dev, (n, 8))
        else:
            material = rand_limbs(torch, gen, dev, (n, 8))
            material.view(torch.int32)[:, 7] &= 0x7FFFFFFF    # Ψ < q
        got, ct = er.wire_roundtrip(sent, material, q=q, mode=mode,
                                    use_kernel=True, return_ct=True)
        bits_equal = torch.equal(got.view(torch.int32),
                                 sent.view(torch.int32))
        words = sent[:2].reshape(2, -1).contiguous().view(torch.int32)
        mask = er._general_mask(material[:2], mode, words.shape[1], 8)
        want = ref.mask_add(field.embed_limbs(words, 8), mask, ql)
        ct_equal = torch.equal(ct[:2].view(torch.int32),
                               want.view(torch.int32))
        checks[direction] = {"decrypted_bits_equal_all_channels": bits_equal,
                             "ciphertext_equals_plain_2_channels": ct_equal}
        assert bits_equal and ct_equal, (mode, direction)
        del ct, want, mask, words
        if direction == "out":
            eye = torch.eye(n, dtype=torch.float32, device=dev)
            sent = ops.coded_matmul(eye, got, b)
        del got
    torch.cuda.empty_cache()
    return checks


def check_staged_cipher(torch, gen, dev) -> dict:
    """The staged round's MEAECC transfer on the card: the kernel core's
    ciphertext equals the plain core's, and decrypts to the sent bits."""
    from repro_torch.crypto import MEAECC, generate_keypair
    from repro_torch.crypto.ecc import shared_secret
    from repro_torch.kernels import ops
    mea = MEAECC(mode="stream", codec="bits", device=dev)
    master, worker = generate_keypair(), generate_keypair()
    x = torch.randn((2, 64, 256), generator=gen, device=dev)
    ok = True
    for i in range(2):
        ct = mea.encrypt(x[i], worker.pk, sender=master, nonce=i + 1)
        pt = shared_secret(mea.curve, master, worker.pk)
        want = ops.mea_encrypt_core(
            mea.codec.encode_words(x[i]), mea._mask_material(pt, i + 1),
            q=mea.curve.q, frac_bits=16, mode="stream", codec="bits",
            n_limbs=8, force_kernel=False)
        back = mea.decrypt(ct, worker)
        ok = ok and torch.equal(ct.payload.view(torch.int32),
                                want.view(torch.int32)) and \
            torch.equal(back.view(torch.int32), x[i].view(torch.int32))
    assert ok
    return {"meaecc_kernel_vs_plain_2_channels": ok}


def encrypted_main_path(torch, randn, gen, dev) -> dict:
    """Phase 5: the encrypted rounds, counted from zero; then, outside the
    count, each round against the plain kernel round and each job's wires.
    Returns the kernel launches of the encrypted rounds."""
    from repro_torch.api import ClusterSpec, CryptoSpec, Session
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel}

    def counts() -> dict:
        return {k: f.launches for k, f in kernels.items()}

    base = ClusterSpec.paper_fig3()
    n = base.code.n_workers
    shapes = {name: (m, d, n_out) for name, m, d, n_out in MAIN_SHAPES}
    inputs = {}
    for name, (m, d, n_out) in shapes.items():
        inputs[name] = (randn(m, d), randn(d, n_out))
    runs = [(name, "stream", None, 3) for name in shapes] + \
        [("fig3_wide", "paper", None, 1), ("fig3_wide", "stream", False, 1)]
    for f in kernels.values():
        f.launches = 0
    expected_total = {k: 0 for k in kernels}
    records = []
    for name, mode, fused, rounds in runs:
        a, b = inputs[name]
        spec = dataclasses.replace(base, crypto=CryptoSpec(
            encrypt="real", cipher_mode=mode, fused=fused))
        torch.cuda.reset_peak_memory_stats()
        with Session(spec, device="cuda") as s:
            for r in range(rounds):
                c0 = counts()
                out, st = s.matmul(a, b)
                torch.cuda.synchronize()
                c1 = counts()
                got = {k: c1[k] - c0[k] for k in kernels}
                # per round: 4 wire launches fused, 2 per transfer staged;
                # the first round of an engine adds its one-time probes:
                # the modeled-rate sample (2 encrypt/decrypt round trips)
                # and, fused, the crypto_s probe of the shape's wires
                if fused is False:
                    wires = 2 * (n + st.n_waited)
                    first = 4
                else:
                    wires = 4
                    first = 8
                want = {"coded_matmul": 1, "berrut_combine": 2,
                        "mask_add": wires + (first if r == 0 else 0)}
                assert got == want, (name, mode, fused, r, got, want)
                assert st.dispatches == 3 + wires, (st.dispatches, wires)
                assert _build.build_count == 1, _build.build_count
                assert tuple(out.shape) == (shapes[name][0], shapes[name][2])
                assert bool(torch.isfinite(out).all())
                for k in kernels:
                    expected_total[k] += want[k]
                records.append({"job": name, "mode": mode, "fused": fused,
                                "round": r, "out": out, "stats": st,
                                "launches": got,
                                "peak_gb": torch.cuda.max_memory_allocated()
                                / 1e9})
        torch.cuda.empty_cache()
    total = counts()
    assert total == expected_total, (total, expected_total)

    # ---- outside the count: the plain kernel round, the wires
    plain = {}
    with Session(base, device="cuda") as p:
        for name in shapes:
            a, b = inputs[name]
            for r in range(3):
                plain[(name, r)] = p.matmul(a, b, round_idx=r)
    wire_checks = {(name, "stream"): check_wires(torch, gen, dev,
                                                 *inputs[name], "stream")
                   for name in shapes}
    wire_checks[("fig3_wide", "paper")] = check_wires(
        torch, gen, dev, *inputs["fig3_wide"], "paper")
    staged_check = check_staged_cipher(torch, gen, dev)
    for rec in records:
        st = rec["stats"]
        want, pst = plain[(rec["job"], rec["round"])]
        err, rel = rel_diff(torch, rec["out"], want)
        row = {"phase": "encrypted_main_path", "job": rec["job"],
               "A": list(inputs[rec["job"]][0].shape),
               "B": list(inputs[rec["job"]][1].shape),
               "cipher_mode": rec["mode"],
               "crypto_fused": rec["fused"] is not False,
               "round": rec["round"], "launches": rec["launches"],
               "vs_plain_round_max_abs": err, "vs_plain_round_rel": rel,
               "bitwise_equal_plain_round": torch.equal(rec["out"], want),
               "n_waited": st.n_waited,
               "arrivals_equal_plain": [w for _, w in st.arrivals] ==
               [w for _, w in pst.arrivals],
               "encode_s": st.encode_s, "crypto_s": st.crypto_s,
               "decode_s": st.decode_s,
               "crypto_modeled_s": st.crypto_modeled_s,
               "plain_round_encode_s": pst.encode_s,
               "dispatches": st.dispatches,
               "peak_memory_gb": rec["peak_gb"],
               "wires": (staged_check if rec["fused"] is False else
                         wire_checks[(rec["job"], rec["mode"])])}
        emit(row)
        assert rel <= ROUND_TOL, row
        assert row["bitwise_equal_plain_round"], row
        assert row["arrivals_equal_plain"], row
    del records, plain, inputs
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 7: the training main path (paper Algorithm 2, Fig. 3/4)
# ---------------------------------------------------------------------------

TRAIN_SCHEMES = ("conv", "mds", "matdot", "spacdc")
TRAIN_STEPS = 16                      # one epoch of 4096 samples, batch 256
TRAIN_STRAGGLERS = 5
# berrut_combine / coded_matmul launches per coded round, by scheme: the
# fused round (conv, spacdc) is one of each; the loop round's encodes and
# decode are berrut_combine (mds 1 + 1, matdot 2 + 1)
ROUND_LAUNCHES = {"conv": {"coded_matmul": 1, "berrut_combine": 1},
                  "spacdc": {"coded_matmul": 1, "berrut_combine": 1},
                  "mds": {"coded_matmul": 0, "berrut_combine": 2},
                  "matdot": {"coded_matmul": 0, "berrut_combine": 3}}


def train_spec(scheme: str, use_kernel=None):
    """``examples/spacdc_dl_mnist.py``'s ``scheme_spec``: N=30, T=3 for
    spacdc, K=24 (p=12 for matdot), S=5, the paper config's seed."""
    from repro_torch.api import (ClusterSpec, CodeSpec, PrivacySpec,
                                 StragglerSpec)
    from repro_torch.configs.spacdc_paper import CONFIG as PAPER
    return ClusterSpec(
        code=CodeSpec(scheme=scheme, n_workers=PAPER.n_workers,
                      k_blocks=12 if scheme == "matdot" else 24,
                      use_kernel=use_kernel),
        privacy=PrivacySpec(t_colluding=PAPER.t_colluding
                            if scheme == "spacdc" else 0),
        straggler=StragglerSpec(n_stragglers=TRAIN_STRAGGLERS),
        seed=PAPER.seed)


def run_training(torch, dev, spec, sizes, data, kernels: dict,
                 ratios=None) -> dict:
    """``examples/spacdc_dl_mnist.py``'s ``run_scheme`` for one epoch on
    the card: ``init_mlp``, the warm-up round per coded layer, then
    TRAIN_STEPS ``train_step`` calls, counted from zero, each timed on the
    host between synchronizes; then, outside the count, the test accuracy
    and one profiled step more.  With a ``ratios`` list, every
    ``berrut_combine`` call is also held against its plain version
    (``hold_combines``), which the step times then include."""
    import statistics
    from repro_torch.api import Session
    from repro_torch.configs.spacdc_paper import CONFIG as PAPER
    xtr, ytr, xte, yte = data
    bs = PAPER.batch_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with Session(spec, device=dev) as s:
        s.init_mlp(sizes, lr=PAPER.lr, seed=PAPER.seed)
        if ratios is not None:
            hold_combines(torch, s.engine.scheme, ratios)
        # warm the rounds so the virtual clock prices steady-state workers
        for w in s.mlp_weights[1:]:
            s.matmul(w, torch.zeros((w.shape[1], bs), device=w.device),
                     round_idx=0)
        n_warm = len(s.round_stats)
        for f in kernels.values():
            f.launches = 0
        step_ms, losses, w_step1 = [], [], None
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = s.train_step(xtr[i * bs:(i + 1) * bs],
                                   ytr[i * bs:(i + 1) * bs])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if i == 0:
                w_step1 = [w.clone() for w in s.mlp_weights]
        launches = {k: f.launches for k, f in kernels.items()}
        stats = s.round_stats[n_warm:]
        acc = s.mlp_accuracy(xte, yte)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        i = TRAIN_STEPS % (xtr.shape[0] // bs)
        prof = profile_device(torch, lambda: s.train_step(
            xtr[i * bs:(i + 1) * bs], ytr[i * bs:(i + 1) * bs]),
                              STEP_CLASSES)
        path = "fused" if s.engine.use_fused else "loop"
    rounds_per_step = len(sizes) - 2
    master_ms = [sum(1e3 * (st.encode_s + st.decode_s + st.crypto_s)
                     for st in stats[k:k + rounds_per_step])
                 for k in range(0, len(stats), rounds_per_step)]
    return {"path": path, "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms),
            "median_coded_round_master_ms": statistics.median(master_ms),
            "virtual_total_s": sum(st.total_s for st in stats),
            "virtual_compute_wait_s": sum(st.compute_wait_s for st in stats),
            "first_loss": losses[0], "final_loss": losses[-1],
            "test_accuracy": acc, "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in launches.items()},
            "dispatches": sum(st.dispatches for st in stats),
            "n_waited": sorted({st.n_waited for st in stats}),
            "n_waited_by_round": [st.n_waited for st in stats],
            "rounds": len(stats), "peak_memory_gb": peak_gb,
            "profiled_step": prof, "w_step1": w_step1}


def exact_first_step(torch, dev, sizes, data) -> list:
    """The weights after the first ``train_step`` computed in float64 with
    the coded product exact (``delta @ W^T`` uncoded): what the float32
    runs approximate."""
    import types
    from repro_torch.api import coded_mlp_init, coded_mlp_step
    from repro_torch.configs.spacdc_paper import CONFIG as PAPER
    xtr, ytr = data[0], data[1]
    bs = PAPER.batch_size
    w, b = coded_mlp_init(sizes, PAPER.seed, device=dev)
    w, b = [t.double() for t in w], [t.double() for t in b]
    exact = types.SimpleNamespace(total_s=0.0)
    coded_mlp_step(w, b, lambda a, m, round_idx: (a @ m, exact),
                   xtr[:bs].double(), ytr[:bs], lr=PAPER.lr)
    return w


# float32's unit roundoff
U32 = 2.0 ** -24


def combine_bound_ratio(torch, w, blocks, got, want=None) -> float:
    """Two float32 ``berrut_combine`` results of the same inputs, ``got``
    and ``want``, held elementwise to what float32 rounding can explain:
    the max over the outputs of |got - want| / (2 γ_J (|W| @ |B|)), with
    γ_J = J u / (1 - J u) and u = 2^-24.  A float32 sum of J products, in
    any order, fused or not, lies within γ_J (|W| @ |B|) of the exact sum,
    so two of them lie within twice that however ill-conditioned W is: a
    ratio above 1 is an error no rounding explains.  ``w`` as the scheme
    hands it in (float64 numpy or a tensor), cast to float32 as
    ``ops.berrut_combine`` casts it; ``blocks`` the float32 (J, ...)
    payload.  Taken over column chunks of at most 2^26 outputs, so that
    the float64 temporaries of a large call stay near 0.5 GB each.
    ``want`` None: the plain version (``kernels.ref.berrut_combine``, what
    ``ops.berrut_combine`` runs on the CPU) is run here on each column
    chunk, so that holding a call costs no second output of its full
    size."""
    from repro_torch.kernels import ref
    assert blocks.dtype == got.dtype == torch.float32
    assert want is None or want.dtype == torch.float32
    j = blocks.shape[0]
    w32 = torch.as_tensor(w).to(device=got.device, dtype=torch.float32)
    w64 = w32.double()
    flat = blocks.reshape(j, -1)
    got = got.reshape(w64.shape[0], -1)
    if want is not None:
        want = want.reshape(w64.shape[0], -1)
    gamma2 = 2 * j * U32 / (1 - j * U32)
    step = max(1, (1 << 26) // max(w64.shape[0], 1))
    worst = 0.0
    for c in range(0, flat.shape[1], step):
        cols = flat[:, c:c + step]
        plain = (want[:, c:c + step] if want is not None else
                 ref.berrut_combine(w32, cols))
        limit = (w64.abs() @ cols.double().abs()) * gamma2
        diff = (got[:, c:c + step].double() - plain.double()).abs()
        ratio = torch.where(limit > 0, diff / limit,
                            torch.where(diff > 0, float("inf"), 0.0))
        if ratio.numel():
            worst = max(worst, float(ratio.max()))
    return worst


def hold_combines(torch, scheme, ratios: list) -> None:
    """Make every ``berrut_combine`` call of ``scheme`` (each encode and
    decode of its rounds) also run the plain version on the same inputs
    and append their ``combine_bound_ratio`` to ``ratios``.  The plain
    version launches no kernel, so the launch counts stay the round's."""
    from repro_torch.kernels import ops
    run = scheme._combine

    def combine(w, blocks):
        got = run(w, blocks)
        want = ops.berrut_combine(w, blocks, force_kernel=False)
        ratios.append(combine_bound_ratio(torch, w, blocks, got, want))
        return got
    scheme._combine = combine


def f64_rule(torch, got, want, exact) -> dict:
    """``got`` against the float64 ``exact``, at most 4x as far off as
    ``want`` (the plain version, or the reference) plus 1e-6 of max
    |exact|: the rule for float32 results whose rounding an ill-conditioned
    decode amplifies, where ``got`` and ``want`` did not start from the
    same float32 inputs.  Each argument a tensor or an array, or a list of
    them (an MLP's layers).  Returns the max |error| of each, max |exact|
    and whether the rule ``holds``."""
    import numpy as np

    def parts(x):
        return [t if isinstance(t, torch.Tensor) else
                torch.from_numpy(np.array(t))
                for t in (x if isinstance(x, (list, tuple)) else [x])]
    exact = [e.double() for e in parts(exact)]

    def err(x):
        return max(float((t.to(e.device).double() - e).abs().max())
                   for t, e in zip(parts(x), exact))
    out = {"kernel_max_abs": err(got), "plain_max_abs": err(want),
           "exact_max_abs": max(float(e.abs().max()) for e in exact)}
    out["holds"] = out["kernel_max_abs"] <= 4 * out["plain_max_abs"] + \
        1e-6 * out["exact_max_abs"]
    return out


def training_main_path(torch, dev) -> dict:
    """Phase 7: ``examples/spacdc_dl_mnist.py``'s four-scheme comparison on
    the card (784-512-10, one epoch), then spacdc on the paper config's
    784-512-256-10, each run counted from zero.  Each scheme runs through
    the kernels and with the kernels forced off in the order kernel,
    plain, plain, kernel, so neither side always runs first; its row
    reports both sides' median step over their two runs and each run's.
    Checks: (a) the first kernel run against the first plain run: step-1
    loss within 1e-5 relative, final accuracy within 0.02; the weights
    after step 1 within 1e-5 of max |w| on the fused round; on the loop
    round of mds and matdot, whose float32 decodes are ill-conditioned,
    each run's weights against the float64 step by ``f64_rule``, and a
    fifth run that holds every ``berrut_combine`` call of its rounds
    against the plain version on the same inputs (``combine_bound_ratio``
    at most 1), as it does for the fused round's decodes; (b) every
    accuracy >= 0.95; (c) conv's summed virtual wait exceeds spacdc's; (d)
    one mds loop round with ``encrypt="real"`` at the Fig-3 backward job is
    bit-identical to the plain loop round.  Returns the first kernel runs'
    launches."""
    import statistics
    from repro_torch.api import CryptoSpec, Session
    from repro_torch.configs.spacdc_paper import CONFIG as PAPER
    from repro_torch.data import synthetic_mnist
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    phase_t0 = time.perf_counter()
    arrays = synthetic_mnist(n_train=4096, n_test=1024, seed=PAPER.seed)
    data = tuple(torch.from_numpy(x).to(dev) for x in arrays)   # set-up
    runs = [(scheme, (784, 512, 10)) for scheme in TRAIN_SCHEMES] + \
        [("spacdc", PAPER.layer_sizes)]
    total = {k: 0 for k in kernels}
    rows = []
    for scheme, sizes in runs:
        k_spec, p_spec = train_spec(scheme), train_spec(scheme,
                                                        use_kernel=False)
        order = [k_spec, p_spec, p_spec, k_spec]
        k_run, p_run, p_run2, k_run2 = [
            run_training(torch, dev, sp, sizes, data, kernels)
            for sp in order]
        rounds = TRAIN_STEPS * (len(sizes) - 2)
        want = {k: rounds * ROUND_LAUNCHES[scheme].get(k, 0)
                for k in kernels}
        for k in total:
            total[k] += k_run["launches"][k]
        assert k_run2["launches"] == want, (scheme, k_run2["launches"])
        for run in (p_run, p_run2):
            assert not any(run["launches"].values()), run["launches"]
        # every berrut_combine call of a kernel run against the plain
        # version on the same inputs, elementwise
        ratios = []
        held_run = run_training(torch, dev, k_spec, sizes, data, kernels,
                                ratios)
        w_k, w_p = k_run.pop("w_step1"), p_run.pop("w_step1")
        k_run2.pop("w_step1"), p_run2.pop("w_step1")
        w_err = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(w_k, w_p))
        # each run's step-1 weights against the float64 exact step, a record
        # on the fused round and a check on the loop round
        f64 = f64_rule(torch, w_k, w_p,
                       exact_first_step(torch, dev, sizes, data))
        row = {"phase": "training_main_path", "scheme": scheme,
               "layer_sizes": list(sizes), "steps": TRAIN_STEPS,
               "batch": PAPER.batch_size, "lr": PAPER.lr,
               "n_workers": PAPER.n_workers, "stragglers": TRAIN_STRAGGLERS,
               "run_order": ["kernel", "plain", "plain", "kernel"],
               **k_run,
               "median_step_ms": statistics.median(k_run["step_ms"] +
                                                   k_run2["step_ms"]),
               "median_step_ms_by_run": [k_run["median_step_ms"],
                                         k_run2["median_step_ms"]],
               "median_coded_round_master_ms_by_run": [
                   k_run["median_coded_round_master_ms"],
                   k_run2["median_coded_round_master_ms"]],
               "a_plain_first_loss": p_run["first_loss"],
               "a_first_loss_rel": abs(k_run["first_loss"] -
                                       p_run["first_loss"]) /
               abs(p_run["first_loss"]),
               "a_weights_step1_rel": w_err,
               "a_weights_step1_vs_f64": f64,
               "a_combines_held": len(ratios),
               "a_combine_bound_ratio_max": max(ratios),
               "a_plain_test_accuracy": p_run["test_accuracy"],
               "a_plain_median_step_ms": statistics.median(
                   p_run["step_ms"] + p_run2["step_ms"]),
               "a_plain_median_step_ms_by_run": [p_run["median_step_ms"],
                                                 p_run2["median_step_ms"]],
               "a_plain_median_coded_round_master_ms_by_run": [
                   p_run["median_coded_round_master_ms"],
                   p_run2["median_coded_round_master_ms"]],
               "a_plain_final_loss": p_run["final_loss"],
               "expected_launches": want}
        emit(row)
        assert k_run["launches"] == want, (scheme, k_run["launches"], want)
        assert k_run["dispatches"] == sum(want.values()), row
        assert k_run["path"] == ("fused" if scheme in ("conv", "spacdc")
                                 else "loop"), row
        assert row["a_first_loss_rel"] <= 1e-5, row
        # the held run makes the kernel run's berrut_combine calls, the
        # warm-up's and the profiled step's: TRAIN_STEPS + 1 steps' worth
        # and one a profile try (a trace that lost activities is taken
        # again, ``profile_device``)
        per_round = ROUND_LAUNCHES[scheme]["berrut_combine"]
        tries = held_run["profiled_step"]["profile_tries"]
        assert len(ratios) == per_round * (len(sizes) - 2) * \
            (TRAIN_STEPS + 1 + tries), (tries, row)
        assert row["a_combine_bound_ratio_max"] <= 1.0, row
        if k_run["path"] == "fused":
            assert w_err <= 1e-5, row
        else:
            # mds K=24 and matdot's 23 points decode through Vandermonde
            # inverses whose conditioning amplifies any float32 rounding:
            # the two runs part after the first decode, so each is held to
            # the float64 step
            assert f64["holds"], row
        assert abs(k_run["test_accuracy"] -
                   p_run["test_accuracy"]) <= 0.02, row
        assert k_run["test_accuracy"] >= 0.95, row
        assert all(x == x and abs(x) < float("inf")
                   for x in k_run["step_ms"] + [k_run["final_loss"]]), row
        rows.append(row)
    wait = {r["scheme"]: r["virtual_compute_wait_s"] for r in rows[:4]}
    assert wait["conv"] > wait["spacdc"], wait

    # ---- (d) the encrypted mds loop round, outside the count
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    a = torch.randn((512, 10), generator=gen, device=dev)
    b = torch.randn((10, 256), generator=gen, device=dev)
    plain_spec = train_spec("mds")
    real_spec = dataclasses.replace(plain_spec,
                                    crypto=CryptoSpec(encrypt="real"))
    with Session(plain_spec, device=dev) as sp, \
            Session(real_spec, device=dev) as sr:
        want, wst = sp.matmul(a, b, round_idx=1)
        got, gst = sr.matmul(a, b, round_idx=1)
        torch.cuda.synchronize()
    d_row = {"phase": "training_main_path", "check": "d_encrypted_loop_round",
             "scheme": "mds", "A": [512, 10], "B": [10, 256],
             "bitwise_equal_plain_round": torch.equal(got, want),
             "n_waited": gst.n_waited, "crypto_s": gst.crypto_s,
             "encode_s": gst.encode_s, "decode_s": gst.decode_s,
             "dispatches": gst.dispatches,
             "plain_dispatches": wst.dispatches,
             "c_compute_wait_s_by_scheme": wait,
             "phase_s": time.perf_counter() - phase_t0}
    emit(d_row)
    assert d_row["bitwise_equal_plain_round"], d_row
    assert gst.dispatches == 2 + 2 * (30 + gst.n_waited), d_row
    assert gst.crypto_s > 0.0, d_row
    return total


# ---------------------------------------------------------------------------
# phase 8: anytime decoding, ErrorTarget rounds and real threads
# ---------------------------------------------------------------------------

# qwen2-7b FFN down-projection on a 4096-token prefill: A (4096, 18944) @
# B (18944, 3584) under ClusterSpec.anytime_bench() (N=30, K=6, T=2)
ANYTIME_JOB = (4096, 18944, 3584)
ANYTIME_BLK = 683                    # ceil(4096 / K=6) rows per block
ANYTIME_EPS = 5e-2
ANYTIME_WIDE = (1536, 256, 512)      # fig3_wide: the encrypted and threads
                                     # rounds, whose wires dominate there
THREADS_BUDGET_S = 0.01              # the Deadline round's budget: between
                                     # the fast workers and the stragglers
# device kernel classes of an anytime round; the rest is the reassembly,
# the norms and their temporaries
ANYTIME_CLASSES = (("berrut_combine", ("berrut_stream",)),
                   ("coded_matmul", ("encode_split_kernel", "split_b_kernel",
                                     "gemm_3xtf32_kernel")))


def smooth_matrix(m: int, d: int, n_modes: int = 5, decay: float = 2.0,
                  seed: int = 1):
    """``benchmarks/bench_anytime.py``'s anytime workload, copied: rows
    sampled from a few low-frequency cosine harmonics with decaying
    amplitudes, smooth along the block axis, where early decodes carry
    information."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(m)[:, None] / m
    out = np.zeros((m, d))
    for c in range(n_modes):
        out += rng.standard_normal(d)[None, :] * np.cos(np.pi * c * t) \
            / (1.0 + c) ** decay
    return out.astype(np.float32)


def anytime_operands(torch, dev, m: int, d: int, n_out: int):
    """A by ``smooth_matrix`` (seed 1), B standard normal (seed 0), as
    ``benchmarks/bench_anytime.py`` draws them; made on the host, then
    moved (set-up)."""
    import numpy as np
    a = torch.from_numpy(smooth_matrix(m, d)).to(dev)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (d, n_out)).astype(np.float32)).to(dev)
    return a, b


def counted(kernels: dict, total: dict, fn):
    """Run ``fn`` with every kernel's count set to 0 first; add the counts
    to ``total``.  Returns (fn's result, this call's counts)."""
    for f in kernels.values():
        f.launches = 0
    out = fn()
    got = {k: f.launches for k, f in kernels.items()}
    for k, v in got.items():
        total[k] += v
    return out, got


def stop_margins(prox, stop: int, eps: float, min_prefix: int) -> dict:
    """How near ``eps`` the proxies that decided the stop prefix lie:
    ``|prox[stop-1] - eps| / eps`` and the least such margin over the
    prefixes the policy looked at (``min_prefix`` .. ``stop``); and the
    stop prefix these proxies give (the earliest from ``min_prefix`` at or
    below ``eps``, else the whole round), which must be ``stop``."""
    import numpy as np
    prox = np.asarray(prox, np.float64)
    seen = prox[min_prefix - 1:stop]
    seen = seen[np.isfinite(seen)]
    below = [p for p in range(min_prefix, prox.size + 1)
             if prox[p - 1] <= eps]
    return {"stop_from_curve": below[0] if below else int(prox.size),
            "stop_proxy": float(prox[stop - 1]),
            "margin_stop": abs(float(prox[stop - 1]) - eps) / eps,
            "margin_min": float(np.min(np.abs(seen - eps)) / eps)
            if seen.size else None}


def threads_plain_decode(torch, plain_scheme, a, b, stats):
    """The plain version of a threads round's result: ``plain_scheme``
    (kernels forced off, the same seed and hence the same noise) encodes
    A, the responders of ``stats`` multiply, and the scheme's decode
    reassembles, on A's device."""
    resp = sorted(w for _, w in stats.arrivals[:stats.n_waited])
    enc = plain_scheme.encode(a)
    res = torch.stack([torch.matmul(enc[i], b) for i in resp])
    dec = plain_scheme.decode(res, resp)
    return plain_scheme.reconstruct_matmul(dec, a.shape[0], b.shape[-1])


def _use_plain(spec):
    return dataclasses.replace(spec, code=dataclasses.replace(
        spec.code, use_kernel=False))


def anytime_main_path(torch, dev) -> dict:
    """Phase 8: (a) ``Session(ClusterSpec.anytime_bench()).anytime_curve``
    at the full-width job for rounds 0 and 1: one ``coded_matmul`` and one
    ``berrut_combine`` launch each, every point ready, ``best_err``
    non-increasing; against the same curve with the kernels forced off the
    same workers and times and the errors and proxies within ROUND_TOL;
    every prefix decode held elementwise to the plain version
    (``combine_bound_ratio``); (b) three ``error_target`` rounds (eps
    5e-2): 2 launches each, ``n_waited`` < 23, the relative error against
    the float64 product < 2 eps, the kernels-off run's stop index with the
    proxies' margins, the output within ROUND_TOL of max |plain|, the
    median ``encode_s`` of three runs, a profiled round and the peak
    memory; (c) the encrypted error_target rounds at fig3_wide, fused and
    staged, bit-identical to the plain one with exact launches; (d) the
    ``threads`` transport at fig3_wide under ``paper_fig3()``, three
    rounds and one under ``Deadline``, each against the plain decode of
    its own responder set; (e) the spacdc trainer under ``ErrorTarget
    (0.25)``.  Returns the counted runs' launches."""
    import statistics

    import numpy as np
    from repro_torch.api import (CryptoSpec, ClusterSpec, Session,
                                 TransportSpec, WaitSpec)
    from repro_torch.configs.spacdc_paper import CONFIG as PAPER
    from repro_torch.data import synthetic_mnist
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    two = {"coded_matmul": 1, "berrut_combine": 1, "mask_add": 0,
           "flash_attention": 0}
    phase_t0 = time.perf_counter()
    m, d, n_out = ANYTIME_JOB
    a, b = anytime_operands(torch, dev, m, d, n_out)
    exact = torch.matmul(a.double(), b.double())         # the float64 C
    exact_norm = float(torch.linalg.vector_norm(exact))
    spec = ClusterSpec.anytime_bench()
    n_workers = spec.code.n_workers
    assert -(-m // spec.code.k_blocks) == ANYTIME_BLK

    # ---- (a) the curve, rounds 0 and 1
    curves = {}
    with Session(spec, device=dev) as sk, \
            Session(_use_plain(spec), device=dev) as sp, \
            Session(spec, device=dev) as sh:
        for r in (0, 1):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pts, launched = counted(kernels, total, lambda: sk.anytime_curve(
                a, b, round_idx=r))
            torch.cuda.synchronize()
            curve_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # the plain session prices its workers with the kernel
            # session's measured time, so the two timelines are one
            sp.engine._worker_t.update(sk.engine._worker_t)
            want = sp.anytime_curve(a, b, round_idx=r)
            ratios = []
            undo = hold_ops_combines(torch, ratios)
            try:
                sh.anytime_curve(a, b, round_idx=r)
            finally:
                undo()
            gaps = {key: [abs(getattr(g, key) - getattr(w, key))
                          for g, w in zip(pts, want)
                          if getattr(w, key) != float("inf")]
                    for key in ("rel_err", "proxy")}
            rel_gaps = {key: max(abs(getattr(g, key) - getattr(w, key)) /
                                 abs(getattr(w, key))
                                 for g, w in zip(pts, want)
                                 if 0 < abs(getattr(w, key)) < float("inf"))
                        for key in ("rel_err", "proxy")}
            first_below = next((p for p in pts
                                if p.ready and p.best_err <= ANYTIME_EPS),
                               None)
            row = {"phase": "anytime_main_path", "check": "a_curve",
                   "round": r, "A": [m, d], "B": [d, n_out],
                   "spec": "anytime_bench", "curve_s": curve_s,
                   "launches": launched,
                   "points": [dataclasses.asdict(p) for p in pts],
                   "first_ready": dataclasses.asdict(pts[0]),
                   "first_below_eps": dataclasses.asdict(first_below)
                   if first_below else None,
                   "eps": ANYTIME_EPS,
                   "vs_plain_max_abs_gap": {k: max(v) for k, v in
                                            gaps.items()},
                   "vs_plain_max_rel_gap": rel_gaps,
                   "prefix_decode_bound_ratio": ratios,
                   "peak_memory_gb": peak_gb}
            emit(row)
            assert launched == two, row
            assert _build.build_count == 1, _build.build_count
            assert len(pts) == n_workers and all(p.ready for p in pts), row
            best = [p.best_err for p in pts]
            assert all(b2 <= b1 for b1, b2 in zip(best, best[1:])), row
            assert [(p.worker, p.t_s) for p in pts] == \
                [(p.worker, p.t_s) for p in want], row
            assert all(v <= ROUND_TOL for v in rel_gaps.values()), row
            assert len(ratios) == 1 and ratios[0] <= 1.0, row
            curves[r] = [p.proxy for p in pts]
    torch.cuda.empty_cache()

    # ---- (b) three ErrorTarget rounds
    et_spec = dataclasses.replace(spec, wait=WaitSpec(policy="error_target",
                                                      eps=ANYTIME_EPS))
    min_prefix = et_spec.wait.min_prefix
    rows_b = []
    with Session(et_spec, device=dev) as sk, \
            Session(_use_plain(et_spec), device=dev) as sp:
        for r in range(3):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (out, st), launched = counted(kernels, total, lambda: sk.matmul(
                a, b, round_idx=r))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            encode_s = [st.encode_s]
            for _ in range(2):
                (_, st2), more = counted(kernels, total, lambda: sk.matmul(
                    a, b, round_idx=r))
                assert more == two, more
                encode_s.append(st2.encode_s)
            want, wst = sp.matmul(a, b, round_idx=r)
            torch.cuda.synchronize()
            if r not in curves:
                curves[r] = [p.proxy for p in
                             sk.anytime_curve(a, b, round_idx=r)]
            err, rel = rel_diff(torch, out, want)
            diff = out.double() - exact
            rel_f64 = float(torch.linalg.vector_norm(diff)) / exact_norm
            rows = slice(0, m, m // 64)
            rel_slice = float(torch.linalg.vector_norm(diff[rows])) / \
                float(torch.linalg.vector_norm(exact[rows]))
            del diff
            prof = profile_device(torch, lambda: sk.matmul(a, b,
                                                           round_idx=r),
                                  ANYTIME_CLASSES)
            row = {"phase": "anytime_main_path", "check": "b_error_target",
                   "round": r, "eps": ANYTIME_EPS,
                   "n_waited": st.n_waited, "plain_n_waited": wst.n_waited,
                   **stop_margins(curves[r], st.n_waited, ANYTIME_EPS,
                                  min_prefix),
                   "rel_err_vs_f64": rel_f64,
                   "rel_err_vs_f64_64_rows": rel_slice,
                   "kernel_vs_plain_max_abs": err,
                   "kernel_vs_plain_rel": rel,
                   "launches": launched, "dispatches": st.dispatches,
                   "encode_s": encode_s,
                   "median_encode_s": statistics.median(encode_s),
                   "plain_encode_s": wst.encode_s,
                   "compute_wait_s": st.compute_wait_s,
                   "profiled_round": prof, "peak_memory_gb": peak_gb}
            emit(row)
            rows_b.append(row)
            assert launched == two and st.dispatches == 2, row
            assert st.n_waited == wst.n_waited < 23, row
            assert row["stop_from_curve"] == st.n_waited, row
            assert rel_f64 < 2 * ANYTIME_EPS, row
            assert rel <= ROUND_TOL, row
            assert tuple(out.shape) == (m, n_out), row
            del out, want
    del a, b, exact
    torch.cuda.empty_cache()

    # ---- (c) the encrypted ErrorTarget rounds at fig3_wide
    wm, wd, wn = ANYTIME_WIDE
    a, b = anytime_operands(torch, dev, wm, wd, wn)
    rows_c = {}
    with Session(et_spec, device=dev) as sp:
        want, wst = sp.matmul(a, b, round_idx=0)
        for name, fused in (("fused", True), ("staged", False)):
            real = dataclasses.replace(et_spec, crypto=CryptoSpec(
                encrypt="real", fused=fused))
            with Session(real, device=dev) as sr:
                assert sr.engine._crypto_fused == fused
                (got, gst), launched = counted(
                    kernels, total, lambda: sr.matmul(a, b, round_idx=0))
            wires = 2 if fused else n_workers + gst.n_waited
            # an engine's first round adds phase 5's one-time probes: the
            # modeled-rate sample (4 mask_add) and, fused, the crypto_s
            # probe of the shape's wires (4 more)
            expect = {"coded_matmul": 1, "berrut_combine": 2,
                      "mask_add": 2 * wires + (8 if fused else 4),
                      "flash_attention": 0}
            row = {"phase": "anytime_main_path", "check": "c_encrypted",
                   "path": name, "A": [wm, wd], "B": [wd, wn],
                   "bitwise_equal_plain_round": torch.equal(got, want),
                   "n_waited": gst.n_waited,
                   "plain_n_waited": wst.n_waited,
                   "crypto_s": gst.crypto_s, "encode_s": gst.encode_s,
                   "decode_s": gst.decode_s, "launches": launched,
                   "expected_launches": expect,
                   "dispatches": gst.dispatches}
            emit(row)
            rows_c[name] = row
            assert row["bitwise_equal_plain_round"], row
            assert gst.n_waited == wst.n_waited, row
            assert launched == expect, row
            assert gst.dispatches == 3 + 2 * wires, row
            assert gst.crypto_s > 0.0, row

    # ---- (d) the threads transport, paper_fig3 at fig3_wide
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn((wm, wd), generator=gen, device=dev)
    b = torch.randn((wd, wn), generator=gen, device=dev)
    exact = torch.matmul(a.double(), b.double())
    fig3 = ClusterSpec.paper_fig3()
    thr = dataclasses.replace(fig3, transport=TransportSpec(backend="threads"))
    virtual_loop = dataclasses.replace(fig3, code=dataclasses.replace(
        fig3.code, fused=False))
    plain_scheme = _use_plain(fig3).build_scheme()
    loop_launch = {"coded_matmul": 0, "berrut_combine": 2, "mask_add": 0,
                   "flash_attention": 0}
    rows_d = []
    for policy in ("fixed_quantile", "deadline"):
        wait = WaitSpec() if policy == "fixed_quantile" else \
            WaitSpec(policy="deadline", t_budget=THREADS_BUDGET_S)
        spec_t = dataclasses.replace(thr, wait=wait)
        spec_v = dataclasses.replace(virtual_loop, wait=wait)
        torch.cuda.synchronize()
        before_gb = torch.cuda.memory_allocated() / 1e9
        s = Session(spec_t, device=dev)
        try:
            with Session(spec_v, device=dev) as sv:
                for r in range(3 if policy == "fixed_quantile" else 2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (out, st), launched = counted(
                        kernels, total, lambda: s.matmul(a, b, round_idx=r))
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                    vout, vst = sv.matmul(a, b, round_idx=r)
                    want = threads_plain_decode(torch, plain_scheme, a, b, st)
                    torch.cuda.synchronize()
                    err, rel = rel_diff(torch, out, want)
                    norm = float(torch.linalg.vector_norm(exact))
                    rel_t = float(torch.linalg.vector_norm(
                        out.double() - exact)) / norm
                    rel_v = float(torch.linalg.vector_norm(
                        vout.double() - exact)) / norm
                    resp = sorted(w for _, w in st.arrivals[:st.n_waited])
                    vresp = sorted(w for _, w in vst.arrivals[:vst.n_waited])
                    # each consumed arrival on the host clock behind the
                    # same worker's arrival on the virtual clock
                    vt = {w: t for t, w in vst.arrivals}
                    lag = [t - vt[w] for t, w in st.arrivals]
                    row = {"phase": "anytime_main_path",
                           "check": "d_threads", "policy": policy,
                           "round": r, "A": [wm, wd], "B": [wd, wn],
                           "n_waited": st.n_waited,
                           "virtual_n_waited": vst.n_waited,
                           "same_responders_as_virtual": resp == vresp,
                           "vs_plain_decode_max_abs": err,
                           "vs_plain_decode_rel": rel,
                           "rel_err_vs_exact": rel_t,
                           "virtual_loop_rel_err_vs_exact": rel_v,
                           "compute_wait_s": st.compute_wait_s,
                           "virtual_compute_wait_s": vst.compute_wait_s,
                           "arrival_lag_ms": {
                               "median": 1e3 * statistics.median(lag),
                               "max": 1e3 * max(lag)},
                           "arrivals_s": [t for t, _ in st.arrivals],
                           "virtual_arrivals_s": [t for t, _ in
                                                  vst.arrivals],
                           "encode_s": st.encode_s, "decode_s": st.decode_s,
                           "round_wall_s": wall_s,
                           "launches": launched, "dispatches": st.dispatches}
                    if policy == "deadline":
                        row["t_budget_s"] = THREADS_BUDGET_S
                        # the master's wait on the host clock past the
                        # budget: the round's wall time less its encode
                        # and decode (a pool's first round also holds the
                        # threads' warm-up and the worker-time probe)
                        row["wait_overshoot_s"] = (wall_s - st.encode_s -
                                                   st.decode_s -
                                                   THREADS_BUDGET_S) \
                            if r > 0 else None
                    emit(row)
                    rows_d.append(row)
                    assert launched == loop_launch, row
                    assert st.dispatches == 2, row
                    assert rel <= 1e-5, row
                    assert bool(torch.isfinite(out).all()), row
                    if resp == vresp:
                        assert abs(rel_t - rel_v) <= 1e-6 * rel_v, row
                    if policy == "deadline":
                        assert st.compute_wait_s <= THREADS_BUDGET_S, row
                        assert 1 <= st.n_waited < n_workers, row
                    else:
                        assert st.n_waited == 23, row
        finally:
            torch.cuda.synchronize()
            open_gb = torch.cuda.memory_allocated() / 1e9
            t0 = time.perf_counter()
            s.close()
            close_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        join_s = s.engine.pool._threads.join_timeout_s
        emit({"phase": "anytime_main_path", "check": "d_threads_close",
              "policy": policy, "close_s": close_s, "join_timeout_s": join_s,
              "allocated_gb": {"before": before_gb, "open": open_gb,
                               "closed": torch.cuda.memory_allocated() / 1e9},
              "clears_cublas_workspaces": hasattr(
                  torch._C, "_cuda_clearCublasWorkspaces")})
        assert close_s <= join_s + 0.1, close_s
        assert s.engine.pool._executor is None
    del a, b, exact
    torch.cuda.empty_cache()

    # ---- (e) the spacdc trainer under ErrorTarget(0.25)
    arrays = synthetic_mnist(n_train=4096, n_test=1024, seed=PAPER.seed)
    data = tuple(torch.from_numpy(x).to(dev) for x in arrays)   # set-up
    t_spec = dataclasses.replace(train_spec("spacdc"), wait=WaitSpec(
        policy="error_target", eps=0.25))
    run = run_training(torch, dev, t_spec, (784, 512, 10), data, kernels)
    for k in total:
        total[k] += run["launches"][k]
    run.pop("w_step1")
    want = {k: TRAIN_STEPS * v for k, v in two.items()}
    spread = np.asarray(run["n_waited_by_round"])
    row = {"phase": "anytime_main_path", "check": "e_error_target_training",
           "scheme": "spacdc", "layer_sizes": [784, 512, 10], "eps": 0.25,
           **run, "expected_launches": want,
           "n_waited_spread": {"min": int(spread.min()),
                               "median": float(np.median(spread)),
                               "max": int(spread.max())},
           "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    assert run["launches"] == want, row
    assert run["dispatches"] == 2 * TRAIN_STEPS, row
    assert run["path"] == "fused", row
    assert run["test_accuracy"] >= 0.95, row
    return total


# --------------------------------------------------------------------------
# phase 9: continuous-batching coded serving
# --------------------------------------------------------------------------

SERVE_ARCH = "qwen2-7b"
SERVE_ALL_LAYERS = 8                 # "all" at full width: 8 of 28 layers
SERVE_RATE = 40.0                    # the Poisson run's arrivals, req/s
SERVE_SITE_BLK = {"qkv": 1152, "o": 896, "up": 9472, "down": 896}
SERVE_CLASSES = (("berrut_combine", ("berrut_stream",)),
                 ("mask_add", ("mask_add",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                 ("casts", ("copy_kernel",)))


def exact_spec(coded_layers: str, backend: str = "virtual", fused=None):
    """The serve's exact spec (``tests/test_serve.py:18``): mds N = 8, K =
    4, all 8 waited for, no stragglers, 8 slots; the decode is exact up to
    float32 rounding."""
    from repro_torch.api import (ClusterSpec, CodeSpec, ServeSpec,
                                 StragglerSpec, TransportSpec, WaitSpec)
    return ClusterSpec(
        code=CodeSpec(scheme="mds", n_workers=8, k_blocks=4, fused=fused),
        wait=WaitSpec(policy="first_k", k=8),
        straggler=StragglerSpec(n_stragglers=0),
        transport=TransportSpec(backend=backend),
        serve=ServeSpec(coded_layers=coded_layers, max_slots=8))


def hold_ops_combines(torch, ratios: list):
    """Make every ``ops.berrut_combine`` call in the process also run the
    plain version on the same inputs (column chunk by column chunk) and
    append their ``combine_bound_ratio`` to ``ratios``: the serving
    weights' encodes (through the scheme) and every coded site's decode
    (through ``ops.precoded_matmul`` or the wired site), which no scheme's
    ``_combine`` sees.  The plain version launches no kernel, so the
    launch counts stay the serve's.  Returns the function that undoes
    it."""
    from repro_torch.kernels import ops
    run = ops.berrut_combine

    def berrut_combine(weights, blocks, *, force_kernel=None):
        got = run(weights, blocks, force_kernel=force_kernel)
        ratios.append(combine_bound_ratio(torch, weights, blocks, got))
        return got
    ops.berrut_combine = berrut_combine

    def undo():
        ops.berrut_combine = run
    return undo


def hold_ops_mask_adds(torch, held: list):
    """Make every ``mask_add`` kernel call in the process (``ops._limb_ready``
    with ``use_kernel``, which the cipher cores and every wire go through)
    also run the plain version on the same limbs and mask and append
    ``(limb shape, subtract, limbs equal)`` to ``held``: each call is held
    on its own, so an encrypt and a decrypt whose errors cancel over a
    round trip still show.  The plain version launches no kernel, so the
    launch counts stay the caller's.  Returns the function that undoes
    it."""
    from repro_torch.kernels import ops
    run = ops._limb_ready

    def limb_ready(limbs, mask, q, use_kernel, subtract):
        got = run(limbs, mask, q, use_kernel, subtract)
        if use_kernel:
            want = run(limbs, mask, q, False, subtract)
            held.append((tuple(limbs.shape), bool(subtract),
                         torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))))
        return got
    ops._limb_ready = limb_ready

    def undo():
        ops._limb_ready = run
    return undo


def profile_serve_step(torch, session, coded_layers: str,
                       p50_wall_ms: float) -> dict:
    """Exactly one decode step (``ContinuousBatcher._run_step``) of the
    session's warm full-width batcher at bucket 8, on a fresh cache: run
    once unprofiled, then once under ``profile_device``.  Beside the
    profile's own idle shares (of its span and of its wall, both lengthened
    by the profiler), the device's idle share of the unprofiled step's p50
    wall from the served run."""
    import numpy as np
    bat = session._serve_batchers[(SERVE_ARCH, False, 0, coded_layers,
                                   "continuous")]
    cache = bat.model.init_cache(8, 8)
    tok = np.arange(1, 9, dtype=np.int32)
    pos = np.zeros(8, np.int32)
    warm_wall = bat._run_step(cache, tok, pos, 8)[3]
    prof = profile_device(torch, lambda: bat._run_step(cache, tok, pos + 1,
                                                       8), SERVE_CLASSES)
    assert prof["device_busy_ms"] > 0, prof
    return {**prof, "warm_step_wall_ms": warm_wall * 1e3,
            "unprofiled_p50_step_wall_ms": p50_wall_ms,
            "idle_share_of_unprofiled_p50_wall":
                1.0 - prof["device_busy_ms"] / p50_wall_ms}


def serve_summary(rep) -> dict:
    """A ServeReport's numbers: tok/s over busy wall, step p50/p99 on the
    virtual clock and by the measured wall, TTFT p50/p99, steps within
    the Deadline, agreement, launches per step."""
    import numpy as np
    walls = np.asarray(rep.step_wall_s)
    return {"mode": rep.mode, "requests": len(rep.requests),
            "steps": len(rep.step_stats),
            "generated": int(sum(len(r.tokens) for r in rep.requests)),
            "tok_s_busy_wall": rep.tok_s, "busy_wall_s": rep.busy_wall_s,
            "virtual_s": rep.virtual_s,
            "requests_per_s_virtual": rep.requests_per_s,
            "p50_step_virtual_ms": rep.p50_step_s * 1e3,
            "p99_step_virtual_ms": rep.p99_step_s * 1e3,
            "p50_step_wall_ms": float(np.percentile(walls, 50)) * 1e3,
            "p99_step_wall_ms": float(np.percentile(walls, 99)) * 1e3,
            "ttft_p50_ms": float(np.percentile(rep.ttft_s, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(rep.ttft_s, 99)) * 1e3,
            "steps_within_budget": rep.steps_within_budget,
            "argmax_agreement": rep.argmax_agreement,
            "buckets_first_run": rep.trace_count,
            "coded_fraction": rep.coded_fraction,
            "n_waited": sorted(set(st.n_waited for st in rep.step_stats)),
            "dispatches_per_step": sorted(set(st.dispatches
                                              for st in rep.step_stats)),
            "crypto_s_per_step": [st.crypto_s for st in rep.step_stats]}


def teacher_forced(torch, model, step, cache_c, cache_p, tokens, offsets,
                   tol: float, cache_u=None) -> dict:
    """The coded step's logits (``step.logits``) against the plain
    ``decode_step``'s on the same token and per-slot pos stream: the
    largest difference over max |plain|, the near-ties (top-2 margin of
    the plain logits within 2 tol max |plain|) and the argmax
    disagreements outside them.  A MoE model's plain step replays the
    coded step's expert choices (``replay_routes``): at random weights the
    routers' top-k near-ties are everywhere, and one choice that the
    projections' rounding tips the other way makes the logits jump.  With
    ``cache_u`` a third, plain run routes on its own, and the slot-steps
    where some layer chose other experts than the coded step are
    counted."""
    worst, ties, flips, same, other = 0.0, 0, 0, 0, 0
    mask = torch.ones(8)
    for t in range(tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        pos = offsets + t
        routes_c, undo = record_routes()
        try:
            got, cache_c = step.logits(cache_c, tok, pos, mask)
        finally:
            undo()
        undo = replay_routes(torch, routes_c)
        try:
            with torch.no_grad():
                want, cache_p = model.decode_step(cache_p, tok, pos)
        finally:
            undo()
        if cache_u is not None:
            routes_u, undo = record_routes()
            try:
                with torch.no_grad():
                    _, cache_u = model.decode_step(cache_u, tok, pos)
            finally:
                undo()
            if routes_c:                      # a model with MoE layers
                other += int(other_experts(torch, routes_c, routes_u).sum())
        want = want[:, 0].float()
        scale = float(want.abs().max())
        worst = max(worst, float((got.float() - want).abs().max()) / scale)
        top2 = torch.topk(want, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * tol * scale
        ties += int(tie.sum())
        differ = got.argmax(-1) != want.argmax(-1)
        flips += int((differ & ~tie).sum())
        same += int((~differ).sum())
    rows = tokens.shape[0] * tokens.shape[1]
    out = {"max_rel_diff": worst, "tol": tol, "near_ties": ties,
           "flips_outside_near_ties": flips, "argmax_agreement": same / rows,
           "steps": int(tokens.shape[1]), "slots": int(tokens.shape[0])}
    if cache_u is not None:
        out["slot_steps_routed_otherwise_unreplayed"] = other
    return out


def serve_combines(torch, randn, ptxas: dict) -> list:
    """``berrut_combine`` at the serve's shapes against its plain version,
    with its time, ``torch.matmul``'s and its bound: the unembed's encode
    (N=8 over K+T=5 blocks of 38016 x 3584), its decode (K=4 over N=8, M =
    38016 x B) at B in {1, 2, 4, 8}, and the coded layer sites' decodes at
    B = 8."""
    cfg_v, d = 152064, 3584
    blk = cfg_v // 4
    rows = [check_combine(torch, emit, randn(8, 5), randn(5, blk * d),
                          ptxas, case="serve_encode_unembed")]
    for b in (1, 2, 4, 8):
        rows.append(check_combine(torch, emit, randn(4, 8),
                                  randn(8, blk, b), ptxas,
                                  case=f"serve_decode_unembed_b{b}"))
    for site, sblk in SERVE_SITE_BLK.items():
        rows.append(check_combine(torch, emit, randn(4, 8),
                                  randn(8, sblk, 8), ptxas,
                                  case=f"serve_decode_{site}_b8"))
    return rows


def serving_main_path(torch, dev, ptxas: dict, keep=None) -> dict:
    """Phase 9: continuous-batching coded serving of qwen2-7b at full
    width.  (a) ``Session(ClusterSpec.serve_deadline()).serve`` (spacdc
    N=8, K=4, T=1, two stragglers, an 8 ms Deadline,
    ``coded_layers="unembed"``, 8 slots) at full depth: 8 requests of
    prompt 16 and gen 32 all arriving at 0, counted from zero (one
    ``berrut_combine`` for the encode and one per step), then the same
    Poisson-ragged with every ``berrut_combine`` call held to its plain
    version, and one profiled step; (b) the exact spec (mds, first_k 8, no
    stragglers) at full width: teacher-forced coded logits against plain
    logits; (c) ``coded_layers="all"`` at full width over 8 of 28 layers
    (33 launches a step, every call held); (d) ``encrypt="real"`` on
    (c)'s model, tokens bit-identical to the plain wire's, exact
    ``mask_add`` launches; (e) the ``threads`` transport's round mode at
    full width against the virtual round mode, the pool closed within
    ``join_timeout_s``; (f) ``_build.build_count`` still 1.  Returns the
    counted runs' launches; (e)'s tokens go to ``keep["e_threads"]`` when
    a dict is given (phase 11 c serves the same workload over the socket
    mesh)."""
    import gc

    import numpy as np
    from repro_torch.api import ClusterSpec, CryptoSpec, ServeSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.models import build_model
    from repro_torch.models.coded import (build_coded_step,
                                          encode_serving_weights)
    from repro_torch.runtime.engine import RoundEngine
    from repro_torch.runtime.serve_loop import (ContinuousBatcher,
                                                poisson_workload)
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase_t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    cfg8 = dataclasses.replace(cfg, n_layers=SERVE_ALL_LAYERS)

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    combine_rows = serve_combines(torch, randn, ptxas)
    free()

    # ---- (a) full width, full depth, coded unembed
    spec = ClusterSpec.serve_deadline()
    assert (spec.code.scheme, spec.code.n_workers, spec.code.k_blocks,
            spec.privacy.t_colluding, spec.straggler.n_stragglers,
            spec.wait.t_budget, spec.serve.coded_layers,
            spec.serve.max_slots) == ("spacdc", 8, 4, 1, 2, 0.008,
                                      "unembed", 8)
    torch.cuda.reset_peak_memory_stats()
    with Session(spec, device=dev) as s:
        t0 = time.perf_counter()
        rep, launched = counted(kernels, total, lambda: s.serve(
            arch=SERVE_ARCH, tiny=False, batch=8, prompt_len=16, gen=32,
            seed=0, check_agreement=True))
        serve_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = len(rep.step_stats)
        want = {"coded_matmul": 0, "berrut_combine": 1 + steps,
                "mask_add": 0, "flash_attention": 0}
        row = {"phase": "serving_main_path", "check": "a_unembed_full",
               "arch": cfg.name, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "workload": {"requests": 8, "prompt": 16, "gen": 32,
                            "arrival_rate": 0.0},
               **serve_summary(rep), "serve_call_s": serve_s,
               "launches": launched, "expected_launches": want,
               "peak_memory_gb": peak_gb}
        emit(row)
        assert launched == want, row
        assert all(st.dispatches == 1 for st in rep.step_stats), row
        assert rep.tokens.shape == (8, 32) and (rep.tokens >= 0).all(), row
        assert (rep.tokens < cfg.vocab_size).all(), row
        assert steps == 16 - 1 + 32, row
        assert rep.steps_within_budget == steps, row
        assert 0.0 <= rep.argmax_agreement <= 1.0, row

        ratios = []
        undo = hold_ops_combines(torch, ratios)
        try:
            rep2 = s.serve(arch=SERVE_ARCH, tiny=False, batch=8,
                           prompt_len=16, gen=32, seed=0,
                           arrival_rate=SERVE_RATE, ragged=True,
                           check_agreement=False)
        finally:
            undo()
        row = {"phase": "serving_main_path", "check": "a_unembed_poisson",
               "workload": {"requests": 8, "prompt": 16, "gen": 32,
                            "arrival_rate": SERVE_RATE, "ragged": True},
               **serve_summary(rep2), "held_calls": len(ratios),
               "max_bound_ratio": max(ratios)}
        emit(row)
        assert len(ratios) == len(rep2.step_stats), row
        assert max(ratios) <= 1.0, row
        assert rep2.steps_within_budget == len(rep2.step_stats), row

        # one profiled step of the warm batcher at bucket 8
        prof = profile_serve_step(torch, s, "unembed",
                                  serve_summary(rep)["p50_step_wall_ms"])
        emit({"phase": "serving_main_path", "check": "a_profiled_step",
              **prof})
    del s, rep, rep2
    free()

    # the same workload uncoded (coded_layers="none"): the plain decode
    # step's wall beside the coded one's
    spec_none = dataclasses.replace(spec, serve=ServeSpec(
        coded_layers="none", max_slots=8))
    with Session(spec_none, device=dev) as s:
        plain = s.serve(arch=SERVE_ARCH, tiny=False, batch=8, prompt_len=16,
                        gen=32, seed=0)
        prof = profile_serve_step(torch, s, "none",
                                  serve_summary(plain)["p50_step_wall_ms"])
    emit({"phase": "serving_main_path", "check": "a_uncoded_same_workload",
          **serve_summary(plain), "profiled_step": prof})
    del s, plain
    free()

    # ---- (b) the exact spec at full width: teacher-forced logits
    model = build_model(cfg, device=dev, seed=0)
    engine = RoundEngine(exact_spec("unembed"), device=dev)
    code = encode_serving_weights(engine.scheme, model, "unembed")
    step = build_coded_step(model, engine.scheme, code)
    tokens = torch.randint(1, cfg.vocab_size, (8, 16), generator=gen,
                           device=dev)
    offsets = torch.arange(8, dtype=torch.int32, device=dev) % 3
    tf = teacher_forced(torch, model, step, model.init_cache(8, 24),
                        model.init_cache(8, 24), tokens, offsets,
                        TOL["bfloat16"])
    row = {"phase": "serving_main_path", "check": "b_exact_teacher_forced",
           "scheme": "mds", "coded_layers": "unembed", **tf}
    emit(row)
    assert tf["max_rel_diff"] <= TOL["bfloat16"], row
    assert tf["flips_outside_near_ties"] == 0, row
    engine.close()
    del model, engine, code, step
    free()

    # ---- (c) coded_layers="all" over 8 full-width layers, every call held
    small = dict(arch=cfg8, batch=2, prompt_len=4, gen=4, seed=0,
                 check_agreement=False)
    spec_all = ClusterSpec.serve_deadline(coded_layers="all")
    torch.cuda.reset_peak_memory_stats()
    with Session(spec_all, device=dev) as s:
        plain_wire = s.serve(**small)          # (d)'s reference, round 0
        # the Deadline plan takes the per-worker time the engine measures:
        # (d) reuses these measurements, so it consumes the same responders
        worker_t = dict(s.engine._worker_t)
        ratios = []
        undo = hold_ops_combines(torch, ratios)
        try:
            rep, launched = counted(kernels, total, lambda: s.serve(
                arch=cfg8, batch=8, prompt_len=4, gen=8, seed=0,
                check_agreement=True))
        finally:
            undo()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sites = 4 * SERVE_ALL_LAYERS + 1
    steps = len(rep.step_stats)
    want = {"coded_matmul": 0, "berrut_combine": sites * steps,
            "mask_add": 0, "flash_attention": 0}
    row = {"phase": "serving_main_path", "check": "c_all_8_layers",
           "layers": SERVE_ALL_LAYERS, "sites_per_step": sites,
           **serve_summary(rep), "launches": launched,
           "expected_launches": want, "held_calls": len(ratios),
           "max_bound_ratio": max(ratios), "peak_memory_gb": peak_gb}
    emit(row)
    assert launched == want, row
    assert all(st.dispatches == sites for st in rep.step_stats), row
    assert len(ratios) == sites * steps, row      # the steps' decodes
    assert max(ratios) <= 1.0, row
    assert 0.0 <= rep.argmax_agreement <= 1.0, row
    del s, rep
    free()

    # ---- (d) encrypt="real" (stream) on (c)'s model, 2 requests
    spec_enc = dataclasses.replace(spec_all,
                                   crypto=CryptoSpec(encrypt="real"))
    held = []
    undo = hold_ops_mask_adds(torch, held)
    try:
        with Session(spec_enc, device=dev) as s:
            s.engine._worker_t.update(worker_t)
            wired, launched = counted(kernels, total,
                                      lambda: s.serve(**small))
            code = next(iter(s._serve_batchers.values())).code
    finally:
        undo()
    steps = len(wired.step_stats)
    # each site's wire shapes at the served bucket: the activations out
    # (N, B·d_in) and the results back (N, blk·B) words, 8 limbs a word
    bucket = 2
    site_shapes = sorted({(8, bucket * m.d_in, 8)
                          for *_, m in code._instances()}
                         | {(8, m.blk * bucket, 8)
                            for *_, m in code._instances()})
    held_shapes = sorted({shape for shape, _, _ in held})

    def responders(rep):
        return [sorted(w for _, w in st.arrivals[:st.n_waited])
                for st in rep.step_stats]
    # the encodes, each step's decodes and four mask_add launches a site
    # (the activations out and the results back, encrypt and decrypt),
    # and the crypto_s probe's eight (warm-up and timed, both wires)
    want = {"coded_matmul": 0, "berrut_combine": sites * (1 + steps),
            "mask_add": 4 * sites * steps + 8, "flash_attention": 0}
    row = {"phase": "serving_main_path", "check": "d_encrypted_all",
           **serve_summary(wired), "launches": launched,
           "expected_launches": want,
           "responders_equal_plain_wire":
               responders(wired) == responders(plain_wire),
           "tokens_equal_plain_wire": bool(np.array_equal(wired.tokens,
                                                          plain_wire.tokens)),
           "mask_add_held_calls": len(held),
           "mask_add_held_equal": sum(ok for *_, ok in held),
           "mask_add_site_shapes": site_shapes,
           "mask_add_held_shapes": held_shapes}
    emit(row)
    assert row["responders_equal_plain_wire"], row
    assert row["tokens_equal_plain_wire"], row
    assert launched == want, row
    assert len(held) == launched["mask_add"], row
    assert all(ok for *_, ok in held), row
    assert set(site_shapes) <= set(held_shapes), row
    assert all(st.crypto_s > 0 for st in wired.step_stats), row
    del s, code
    free()

    # ---- (e) the threads transport, unembed round mode, full width
    reqs = poisson_workload(2, rate_rps=0.0, prompt_len=4, gen=4,
                            vocab=cfg.vocab_size, seed=0, ragged=False)
    s = Session(exact_spec("unembed", backend="threads"), device=dev)
    try:
        threads = s.serve(arch=SERVE_ARCH, tiny=False, requests=reqs,
                          check_agreement=False)
    finally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.close()
        close_s = time.perf_counter() - t0
    join_s = s.engine.pool._threads.join_timeout_s
    assert s.engine.pool._executor is None
    del s
    free()
    model = build_model(cfg, device=dev, seed=0)
    engine = RoundEngine(exact_spec("unembed", fused=False), device=dev)
    virtual = ContinuousBatcher(engine, model, coded_layers="unembed",
                                max_slots=8, backend="threads").run(reqs)
    engine.close()
    del model, engine
    free()
    same = all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(threads.requests, virtual.requests))
    row = {"phase": "serving_main_path", "check": "e_threads_round",
           **serve_summary(threads), "virtual_round_mode": {
               "mode": virtual.mode, "steps": virtual.n_steps,
               "busy_wall_s": virtual.busy_wall_s},
           "tokens_equal_virtual_round_mode": same, "close_s": close_s,
           "join_timeout_s": join_s}
    emit(row)
    assert threads.mode == "round" and virtual.mode == "round", row
    assert same, row
    if keep is not None:
        keep["e_threads"] = [r.tokens for r in threads.requests]
    assert close_s <= join_s + 0.1, row

    # ---- (f) churn rebuilt nothing
    emit({"phase": "serving_main_path", "check": "f_build_count",
          "build_count": _build.build_count,
          "combine_rows": [{"case": r["case"], "kernel_ms": r["kernel_ms"],
                            "library_ms": r["library_ms"],
                            "bound_ms": r["bound_ms"]}
                           for r in combine_rows],
          "phase_s": time.perf_counter() - phase_t0})
    assert _build.build_count == 1, _build.build_count
    return total


# --------------------------------------------------------------------------
# phase 10: fault-tolerant and adaptive coded rounds, the later baselines
# --------------------------------------------------------------------------

# (a)/(b): the qwen2-7b FFN down-projection of one 4096-token prefill,
# Gaussian, at benchmarks/bench_faults.py's operating point
FAULT_JOB = (4096, 18944, 3584)
FAULT_OP = dict(n_workers=24, k_blocks=4, fh_degree=3, t_colluding=2,
                noise_scale=0.01, n_stragglers=3, seed=11, crash_rate=0.12,
                corrupt_rate=0.12, corrupt_scale=1e3, quarantine_after=3,
                max_retries=2)
FAULT_ROUNDS = 10
DEFENDED_REL_MAX = 1e-2
UNDEFENDED_REL_MIN = 1e-1
# (d): the qwen2-7b FFN up-projection of one 4096-token prefill, Gaussian,
# at benchmarks/bench_adaptive.py's operating point
ADAPTIVE_JOB = (4096, 3584, 18944)
ADAPTIVE_OP = dict(n_workers=16, k_blocks=8, t_colluding=1, noise_scale=0.01,
                   n_stragglers=4, seed=7, delay_s=0.03, jitter_scale=0.002)
ADAPTIVE_ROUNDS, ADAPTIVE_REGIME = 48, 16
ADAPTIVE_TARGET = 0.12
ADAPTIVE_RATIO_FLOOR = 1.1           # bench_adaptive.py's full-run floor
# (e): loop rounds of the later baselines at fig3_wide, float32 decodes
# against the float64 product: the exact codes to float32 rounding times
# their Lagrange/Vandermonde conditioning, BACC (rateless, approximate) to
# test_registry.py's own f32 tolerance
BASELINE_REL_MAX = {"lcc": 1e-3, "glcc": 1e-3, "secpoly": 1e-3, "bacc": 0.15}
# device kernel classes of a fault round, first match wins
FAULT_CLASSES = (("berrut_combine", ("berrut_stream",)),
                 ("float64_screen", ("double", "f64", "dgemm", "dmma")),
                 ("worker_products", ("gemm", "xmma", "cutlass", "nvjet")))


def gaussian(torch, dev, shape, seed: int):
    """A standard-normal float32 matrix made on the device from a seeded
    generator (the benchmarks' Gaussian operands, at full width)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def f64_product(torch, a, b, cols: int = 2048):
    """The float64 product a @ b, built over column chunks of b."""
    a64 = a.double()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float64,
                      device=a.device)
    for c in range(0, b.shape[1], cols):
        out[:, c:c + cols] = a64 @ b[:, c:c + cols].double()
    return out


def rel_to(torch, out, exact, exact_norm: float) -> float:
    """||out - exact|| / ||exact|| in float64, over row chunks."""
    sq = 0.0
    for r in range(0, out.shape[0], 1024):
        sq += float(torch.linalg.vector_norm(
            out[r:r + 1024].double() - exact[r:r + 1024]) ** 2)
    return sq ** 0.5 / exact_norm


def fault_spec(*, handle: bool, encrypt=None, corrupt_only: bool = False,
               use_kernel=None):
    """``benchmarks/bench_faults.py``'s spec: the defended or undefended
    trace, or (``corrupt_only``) the exclusion proof's round."""
    from repro_torch.api import (ClusterSpec, CodeSpec, CryptoSpec,
                                 FaultSpec, PrivacySpec, StragglerSpec)
    op = FAULT_OP
    fault = FaultSpec(
        crash_rate=0.0 if corrupt_only else op["crash_rate"],
        corrupt_rate=0.25 if corrupt_only else op["corrupt_rate"],
        corrupt_scale=op["corrupt_scale"], handle=handle,
        max_retries=0 if corrupt_only else op["max_retries"],
        quarantine_after=op["quarantine_after"],
        seed=5 if corrupt_only else None)
    return ClusterSpec(
        code=CodeSpec(scheme="spacdc", n_workers=op["n_workers"],
                      k_blocks=op["k_blocks"], use_kernel=use_kernel,
                      extra={"fh_degree": op["fh_degree"]}),
        privacy=PrivacySpec(t_colluding=op["t_colluding"],
                            noise_scale=op["noise_scale"]),
        straggler=StragglerSpec(
            n_stragglers=0 if corrupt_only else op["n_stragglers"]),
        crypto=CryptoSpec(encrypt=encrypt), seed=op["seed"], fault=fault)


def corrupted_in_round(spec, round_idx: int) -> set:
    """Every worker some attempt of ``round_idx`` corrupted in its plan."""
    import numpy as np
    from repro_torch.runtime.faults import plan_faults, retry_round_index
    seed = spec.fault.seed if spec.fault.seed is not None else spec.seed
    out = set()
    for att in range(spec.fault.max_retries + 1):
        plan = plan_faults(spec.fault, seed, retry_round_index(round_idx,
                                                               att),
                           spec.code.n_workers)
        out |= set(int(w) for w in np.flatnonzero(plan.corrupt))
    return out


# a clean coded row stays within ~2x the median responder norm (the
# reference's screen docstring measures ~1.4x); an evicted row above 3x it
# is a corrupted result, whatever stage evicted it
CORRUPT_NORM_X = 3.0


def timed_screens(torch):
    """Time every ``screen_responders`` call of the engine (synchronized
    host seconds) and record, per call, the evicted slots' norms over the
    median responder norm and the norm stage's cut (``norm_factor``).
    Returns (times, passes, undo)."""
    import numpy as np
    from repro_torch.runtime import engine as eng_mod
    run = eng_mod.screen_responders
    times: list = []
    passes: list = []

    def screen(scheme, results, mask, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(scheme, results, mask, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        resp = np.flatnonzero(np.asarray(mask))
        norms = torch.linalg.vector_norm(
            results.reshape(len(mask), -1), dim=1,
            dtype=torch.float64).cpu().numpy()
        med = max(float(np.median(norms[resp])), 1e-12)
        passes.append({"evicted_norm_x": [float(norms[s2] / med)
                                          for s2 in out[1]],
                       "norm_cut_x": float(kw.get("norm_factor", 30.0))})
        return out
    eng_mod.screen_responders = screen

    def undo():
        eng_mod.screen_responders = run
    return times, passes, undo


def fault_trace(torch, spec, a, b, exact, exact_norm: float, rounds: int,
                worker_t=None, hold=None):
    """``rounds`` rounds of ``spec`` in one session: a row per round (rel
    err against float64, retries, exclusions, mask, degraded, wait, the
    encode / screen / decode seconds) and the outputs.  ``worker_t`` seeds
    the engine's measured per-worker compute time; ``hold`` collects
    ``combine_bound_ratio`` of every ``berrut_combine`` call."""
    from repro_torch.api import Session
    screens, passes, undo = timed_screens(torch)
    rows, outs = [], []
    try:
        with Session(spec, device=a.device) as s:
            if worker_t is not None:
                s.engine._worker_t = dict(worker_t)
            if hold is not None:
                hold_combines(torch, s.engine.scheme, hold)
            for r in range(rounds):
                n_scr = len(screens)
                out, st = s.matmul(a, b)
                # corrupted results the 30x norm stage let through (their
                # clean rows are small: Berrut rows that nearly cancel)
                escaped = [x for ps in passes[n_scr:]
                           for x in ps["evicted_norm_x"]
                           if CORRUPT_NORM_X < x <= ps["norm_cut_x"]]
                rows.append({
                    "round": r, "rel_err": rel_to(torch, out, exact,
                                                  exact_norm),
                    "retries": st.retries, "excluded": list(st.excluded),
                    "quarantined": list(st.quarantined),
                    "degraded": st.degraded,
                    "achieved_rel_err": st.achieved_rel_err,
                    "decode_mask": list(st.decode_mask),
                    "n_waited": st.n_waited,
                    "compute_wait_s": st.compute_wait_s,
                    "encode_s": st.encode_s,
                    "screen_s": sum(screens[n_scr:]),
                    "escaped_norm_stage_x": escaped,
                    "decode_s": st.decode_s, "crypto_s": st.crypto_s,
                    "launches": st.dispatches})
                outs.append(out)
            health = s.health.snapshot()
            worker_t = dict(s.engine._worker_t)
    finally:
        undo()
    return rows, outs, health, worker_t


def same_fault_rounds(rows_k, rows_p) -> bool:
    keys = ("retries", "excluded", "quarantined", "degraded", "decode_mask",
            "n_waited", "compute_wait_s")
    return all(rk[k] == rp[k] for rk, rp in zip(rows_k, rows_p)
               for k in keys)


def adaptive_spec(*, wait=None, adaptive=None, use_kernel=None,
                  regime_len: int = ADAPTIVE_REGIME):
    """``benchmarks/bench_adaptive.py``'s spec."""
    from repro_torch.api import (AdaptiveSpec, ClusterSpec, CodeSpec,
                                 PrivacySpec, StragglerSpec, WaitSpec)
    op = ADAPTIVE_OP
    return ClusterSpec(
        code=CodeSpec(scheme="spacdc", n_workers=op["n_workers"],
                      k_blocks=op["k_blocks"], use_kernel=use_kernel),
        privacy=PrivacySpec(t_colluding=op["t_colluding"],
                            noise_scale=op["noise_scale"]),
        straggler=StragglerSpec(n_stragglers=op["n_stragglers"],
                                mode="shifting_markov",
                                delay_s=op["delay_s"],
                                jitter_scale=op["jitter_scale"],
                                regime_len=regime_len),
        wait=wait if wait is not None else WaitSpec(),
        adaptive=adaptive if adaptive is not None else AdaptiveSpec(),
        seed=op["seed"])


def fixed_policies():
    """``benchmarks/bench_adaptive.py``'s four fixed baselines."""
    from repro_torch.api import WaitSpec
    return {"fixed_quantile": WaitSpec(),
            "first_k": WaitSpec(policy="first_k", k=10),
            "deadline": WaitSpec(policy="deadline", t_budget=0.010),
            "error_target": WaitSpec(policy="error_target",
                                     eps=ADAPTIVE_TARGET, min_prefix=4)}


def lat_at_err(st, err: float) -> float:
    """bench_adaptive's per-round latency at the error target: the decode
    time, plus the round's makespan when the error misses the target."""
    makespan = (float(st.arrivals[-1][0]) if st.arrivals
                else float(st.decode_at_s))
    return float(st.decode_at_s) + (makespan if err > ADAPTIVE_TARGET
                                    else 0.0)


def hold_first_coded_matmuls(torch, held: dict):
    """Hold the first ``coded_matmul`` kernel launch at every new (J, blk)
    against the plain version on the same inputs: ``held[(J, blk)]`` =
    (max abs err, that over max |plain|).  Returns the undo."""
    from repro_torch.kernels import ops
    run = ops.coded_matmul

    def coded_matmul(weights, blocks, rhs, *, force_kernel=None):
        got = run(weights, blocks, rhs, force_kernel=force_kernel)
        key = (int(blocks.shape[0]), int(blocks.shape[1]))
        if key not in held and ops._use_kernel(blocks, force_kernel):
            want = run(weights, blocks, rhs, force_kernel=False)
            held[key] = rel_diff(torch, got, want)
            del want
        return got
    ops.coded_matmul = coded_matmul

    def undo():
        ops.coded_matmul = run
    return undo


def robust_main_path(torch, dev) -> dict:
    """Phase 10: the fault-tolerant and adaptive rounds and the later
    baselines.  (a) bench_faults's trace at the full-width down-projection:
    10 defended and 10 undefended rounds, a row each; the defended trace
    again with the kernels forced off (same measured compute time) and
    once more with every ``berrut_combine`` call held; one profiled
    defended round; (b) the exclusion proof, plain and ``encrypt="real"``
    with every ``mask_add`` call held; (c) an mds round that runs out of
    retries raises ``DegradedRoundError``; (d) bench_adaptive at the
    full-width up-projection, 48 rounds, against the kernels-off run and
    the four fixed policies; (e) one loop round each of lcc, glcc
    (n_groups 1 and 2), secpoly and bacc at fig3_wide; (f) the health
    snapshot and the adaptive report.  Returns the counted launches."""
    import numpy as np
    from repro_torch.api import (AdaptiveSpec, ClusterSpec, CodeSpec,
                                 FaultSpec, PrivacySpec, Session,
                                 StragglerSpec)
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.runtime.faults import DegradedRoundError, plan_faults
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase_t0 = time.perf_counter()

    # ---- (a) defended and undefended traces at full width
    m, d, n_out = FAULT_JOB
    a = gaussian(torch, dev, (m, d), 42)
    b = gaussian(torch, dev, (d, n_out), 43)
    exact = f64_product(torch, a, b)
    exact_norm = float(torch.linalg.vector_norm(exact))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (rows_d, outs_d, health_d, worker_t), launches_d = counted(
        kernels, total, lambda: fault_trace(
            torch, fault_spec(handle=True), a, b, exact, exact_norm,
            FAULT_ROUNDS))
    (rows_u, _, _, _), launches_u = counted(
        kernels, total, lambda: fault_trace(
            torch, fault_spec(handle=False), a, b, exact, exact_norm,
            FAULT_ROUNDS, worker_t=worker_t))
    traces_s = time.perf_counter() - t0
    for label, rows in (("defended", rows_d), ("undefended", rows_u)):
        for row in rows:
            emit({"phase": "robust_main_path", "check": f"a_{label}", **row})
    spec_d = fault_spec(handle=True)
    stray = [(row["round"], w) for row in rows_d for w in row["excluded"]
             if w not in corrupted_in_round(spec_d, row["round"])]
    # a clean worker is evicted only beside a corrupted result that
    # escaped the norm stage: its leave-one-out prediction leans on that
    # neighbour (the reference's screen, score for score)
    unexplained = [(r, w) for r, w in stray
                   if not rows_d[r]["escaped_norm_stage_x"]]
    n_quar = sum(health_d["n_quarantines"])
    # the kernels-off run on the same measured compute time, then every
    # berrut_combine call of one more kernel run held to the plain version
    rows_p, outs_p, _, _ = fault_trace(
        torch, fault_spec(handle=True, use_kernel=False), a, b, exact,
        exact_norm, FAULT_ROUNDS, worker_t=worker_t)
    k_vs_p = max(rel_diff(torch, ok, op)[1] for ok, op in zip(outs_d,
                                                              outs_p))
    del outs_d, outs_p
    held: list = []
    rows_h, _, _, _ = fault_trace(torch, fault_spec(handle=True), a, b,
                                  exact, exact_norm, FAULT_ROUNDS,
                                  worker_t=worker_t, hold=held)
    # one profiled defended round (outside the counted runs)
    with Session(fault_spec(handle=True), device=dev) as s:
        s.engine._worker_t = dict(worker_t)
        s.matmul(a, b)
        prof = profile_device(torch, lambda: s.matmul(a, b), FAULT_CLASSES)
    row = {"phase": "robust_main_path", "check": "a_summary",
           "job": {"A": [m, d], "B": [d, n_out]}, "op": FAULT_OP,
           "defended_worst_rel_err": max(r["rel_err"] for r in rows_d),
           "undefended_worst_rel_err": max(r["rel_err"] for r in rows_u),
           "total_retries": sum(r["retries"] for r in rows_d),
           "total_excluded": sum(len(r["excluded"]) for r in rows_d),
           "n_degraded": sum(r["degraded"] for r in rows_d),
           "n_quarantine_events": n_quar,
           "excluded_not_corrupted": stray,
           "excluded_not_corrupted_unexplained": unexplained,
           "launches_defended": launches_d,
           "launches_undefended": launches_u,
           "kernels_off_same_rounds": same_fault_rounds(rows_d, rows_p),
           "kernel_vs_plain_rel": k_vs_p,
           "held_combines": len(held),
           "held_worst_bound_ratio": max(held) if held else None,
           "held_run_same_rounds": same_fault_rounds(rows_d, rows_h),
           "profiled_defended_round": prof,
           "traces_s": traces_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    assert row["defended_worst_rel_err"] <= DEFENDED_REL_MAX, row
    assert row["undefended_worst_rel_err"] > UNDEFENDED_REL_MIN, row
    assert row["total_retries"] >= 1 and row["total_excluded"] >= 1, row
    assert n_quar >= 1, row
    assert not unexplained, row
    assert row["kernels_off_same_rounds"] and k_vs_p <= ROUND_TOL, row
    assert row["held_run_same_rounds"], row
    assert held and max(held) <= 1.0, row
    assert launches_d["berrut_combine"] == 2 * FAULT_ROUNDS, row
    assert launches_d["coded_matmul"] == launches_d["mask_add"] == 0, row
    assert prof["device_busy_ms"] > 0, row
    torch.cuda.empty_cache()

    # ---- (b) the exclusion proof: corrupt-only, retries off
    proof_spec = fault_spec(handle=True, corrupt_only=True)
    plan = plan_faults(proof_spec.fault, proof_spec.fault.seed, 0,
                       FAULT_OP["n_workers"])
    corrupted = sorted(int(w) for w in np.flatnonzero(plan.corrupt))
    proofs, outs = {}, {}
    mask_held: list = []
    for label, encrypt in (("plain", None), ("real", "real")):
        undo = hold_ops_mask_adds(torch, mask_held)
        t0 = time.perf_counter()
        try:
            (out, st), launches = counted(
                kernels, total, lambda: run_one(
                    fault_spec(handle=True, corrupt_only=True,
                               encrypt=encrypt), a, b, worker_t))
        finally:
            undo()
        outs[label] = out
        proofs[label] = {
            "encrypt": encrypt, "corrupted_workers": corrupted,
            "excluded_workers": sorted(st.excluded),
            "decode_mask": list(st.decode_mask),
            "rel_err": rel_to(torch, out, exact, exact_norm),
            "crypto_s": st.crypto_s, "round_s": time.perf_counter() - t0,
            "launches": launches}
    row = {"phase": "robust_main_path", "check": "b_exclusion_proof",
           "job": {"A": [m, d], "B": [d, n_out]}, **proofs,
           "plain_equals_real_bitwise": torch.equal(outs["plain"],
                                                    outs["real"]),
           "mask_add_calls_held": len(mask_held),
           "mask_add_calls_equal": sum(ok for *_, ok in mask_held),
           "mask_add_shapes": sorted({str(shp) for shp, *_ in mask_held})}
    emit(row)
    for proof in proofs.values():
        assert corrupted and proof["excluded_workers"] == corrupted, row
        assert all(proof["decode_mask"][w] == 0 for w in corrupted), row
        assert proof["rel_err"] <= DEFENDED_REL_MAX, row
    assert row["plain_equals_real_bitwise"], row
    assert mask_held and all(ok for *_, ok in mask_held), row
    assert proofs["real"]["launches"]["mask_add"] == len(mask_held), row
    del outs, a, b, exact
    torch.cuda.empty_cache()

    # ---- (c) a threshold scheme out of retries
    wm, wd, wn = ANYTIME_WIDE
    aw, bw = gaussian(torch, dev, (wm, wd), 44), gaussian(torch, dev,
                                                         (wd, wn), 45)
    mds = ClusterSpec(code=CodeSpec(scheme="mds", n_workers=8, k_blocks=4),
                      straggler=StragglerSpec(n_stragglers=0), seed=2,
                      fault=FaultSpec(crash_rate=0.7, handle=True,
                                      max_retries=1, seed=1))
    err, raised_at = None, None
    with Session(mds, device=dev) as s:
        for r in range(6):
            try:
                s.matmul(aw, bw)
            except DegradedRoundError as e:
                err, raised_at = e, r
                break
    row = {"phase": "robust_main_path", "check": "c_threshold_degraded",
           "raised_at_round": raised_at,
           "clean_slots": list(err.clean_slots) if err else None,
           "excluded": list(err.excluded) if err else None,
           "retries": err.retries if err else None,
           "needed": err.needed if err else None,
           "results_device": (str(err.results.device) if err is not None
                              and err.results is not None else None),
           "results_shape": (list(err.results.shape) if err is not None
                             and err.results is not None else None)}
    emit(row)
    assert err is not None and err.needed >= 4, row
    assert 1 <= len(err.clean_slots) < 4 and err.retries == 1, row
    assert err.results.device.type == dev.type and tuple(err.results.shape) == (
        len(err.clean_slots), wm // 4, wn), row

    # ---- (d) adaptive against the kernels-off run and the fixed policies
    am, ad, an = ADAPTIVE_JOB
    a = gaussian(torch, dev, (am, ad), 46)
    b = gaussian(torch, dev, (ad, an), 47)
    exact = f64_product(torch, a, b)
    exact_norm = float(torch.linalg.vector_norm(exact))
    ad_spec = AdaptiveSpec(policy="adaptive", target_rel_err=ADAPTIVE_TARGET,
                           warmup_rounds=6, retune_every=2, max_candidates=5)
    cm_held: dict = {}
    torch.cuda.reset_peak_memory_stats()

    def adaptive_runs():
        undo = hold_first_coded_matmuls(torch, cm_held)
        out = {"lat": [], "errs": [], "same": [], "kvp": 0.0, "built": [],
               "builds": [], "rounds": []}
        try:
            with Session(adaptive_spec(adaptive=ad_spec), device=dev) as sk, \
                    Session(adaptive_spec(adaptive=ad_spec,
                                          use_kernel=False),
                            device=dev) as sp:
                for r in range(ADAPTIVE_ROUNDS):
                    got, st = sk.matmul(a, b)
                    sp.engine._worker_t = dict(sk.engine._worker_t)
                    want, wst = sp.matmul(a, b)
                    err = rel_to(torch, got, exact, exact_norm)
                    out["lat"].append(lat_at_err(st, err))
                    out["errs"].append(err)
                    out["same"].append(
                        sk.engine._scheme_token == sp.engine._scheme_token
                        and st.decode_mask == wst.decode_mask
                        and st.policy == wst.policy)
                    out["kvp"] = max(out["kvp"], rel_diff(torch, got,
                                                          want)[1])
                    out["built"].append(len(sk.engine.adaptive._schemes))
                    out["builds"].append(_build.build_count)
                    out["rounds"].append({
                        "round": r, "k_blocks": sk.engine.k,
                        "policy": st.policy, "n_waited": st.n_waited,
                        "decode_at_s": st.decode_at_s, "rel_err": err,
                        "encode_s": st.encode_s, "launches": st.dispatches})
                    del got, want
                out["report"] = sk.adaptive_report()
                out["report_plain"] = sp.adaptive_report()
                out["health"] = sk.health.snapshot()
        finally:
            undo()
        return out
    t0 = time.perf_counter()
    res, launches_ad = counted(kernels, total, adaptive_runs)
    adaptive_s = time.perf_counter() - t0
    peak_ad = torch.cuda.max_memory_allocated() / 1e9
    fixed = {}
    t0 = time.perf_counter()
    for name, wait in fixed_policies().items():
        def run_fixed(wait=wait):
            lats, misses = [], 0
            with Session(adaptive_spec(wait=wait), device=dev) as s:
                for _ in range(ADAPTIVE_ROUNDS):
                    got, st = s.matmul(a, b)
                    err = rel_to(torch, got, exact, exact_norm)
                    lats.append(lat_at_err(st, err))
                    misses += err > ADAPTIVE_TARGET
            return {"lat_at_err_ms": float(np.mean(lats)) * 1e3,
                    "misses": int(misses)}
        fixed[name], _ = counted(kernels, total, run_fixed)
    fixed_s = time.perf_counter() - t0
    best = min(fixed, key=lambda k: fixed[k]["lat_at_err_ms"])
    ad_ms = float(np.mean(res["lat"])) * 1e3
    tail = res["built"][-(ADAPTIVE_ROUNDS // 3):]
    row = {"phase": "robust_main_path", "check": "d_adaptive",
           "job": {"A": [am, ad], "B": [ad, an]}, "op": ADAPTIVE_OP,
           "rounds": ADAPTIVE_ROUNDS, "regime_len": ADAPTIVE_REGIME,
           "adaptive_lat_at_err_ms": ad_ms,
           "adaptive_misses": int(sum(e > ADAPTIVE_TARGET
                                      for e in res["errs"])),
           "fixed": fixed, "best_fixed": best,
           "adaptive_vs_best_fixed_x": fixed[best]["lat_at_err_ms"] / ad_ms,
           "reference_floor_x": ADAPTIVE_RATIO_FLOOR,
           "decisions": [(dd["round_idx"], dd["k_blocks"], dd["wait_for"])
                         for dd in res["report"]["decisions"]],
           "kernels_off_same_decisions": all(res["same"]) and
           [dict(dd, predicted_rel_err=None)
            for dd in res["report"]["decisions"]] ==
           [dict(dd, predicted_rel_err=None)
            for dd in res["report_plain"]["decisions"]],
           "kernel_vs_plain_rel": res["kvp"],
           "coded_matmul_held": {f"J={j},blk={blk}": v[1]
                                 for (j, blk), v in sorted(cm_held.items())},
           "schemes_built_by_round": res["built"],
           "build_count": _build.build_count,
           "launches": launches_ad, "per_round": res["rounds"],
           "adaptive_s": adaptive_s, "fixed_s": fixed_s,
           "peak_memory_gb": peak_ad}
    emit(row)
    assert row["kernels_off_same_decisions"], row
    assert res["kvp"] <= ROUND_TOL, row
    assert cm_held and all(v[1] <= TOL["float32"]
                           for v in cm_held.values()), row
    assert len(cm_held) == len({dd["k_blocks"] for dd in
                                res["report"]["decisions"]} |
                               {ADAPTIVE_OP["k_blocks"]}), row
    assert tail[0] == tail[-1], row
    assert set(res["builds"]) == {1}, row
    assert res["report"]["decisions"], row
    health_ad, report_ad = res["health"], res["report"]
    del a, b, exact, res
    torch.cuda.empty_cache()

    # ---- (e) the later baselines, one loop round each at fig3_wide
    exact_w = f64_product(torch, aw, bw)
    norm_w = float(torch.linalg.vector_norm(exact_w))
    base_rows = []
    for name, extra, expect in (("lcc", {}, 2), ("glcc", {"n_groups": 1}, 2),
                                ("glcc", {"n_groups": 2}, 4),
                                ("secpoly", {}, 3), ("bacc", {}, 2)):
        spec = ClusterSpec(
            code=CodeSpec(scheme=name, n_workers=30, k_blocks=4,
                          fused=False, extra=extra),
            privacy=PrivacySpec(t_colluding=1, noise_scale=0.01),
            straggler=StragglerSpec(n_stragglers=7), seed=0)
        ratios: list = []
        undo = hold_ops_combines(torch, ratios)
        try:
            (out, st), launches = counted(
                kernels, total, lambda spec=spec: run_one(spec, aw, bw))
        finally:
            undo()
        rel = rel_to(torch, out, exact_w, norm_w)
        base_rows.append({"scheme": name, **extra, "rel_err_vs_f64": rel,
                          "tol": BASELINE_REL_MAX[name],
                          "n_waited": st.n_waited, "launches": launches,
                          "held": len(ratios),
                          "worst_bound_ratio": max(ratios)})
        assert rel <= BASELINE_REL_MAX[name], base_rows[-1]
        assert launches["berrut_combine"] == expect == len(ratios), \
            base_rows[-1]
        assert max(ratios) <= 1.0, base_rows[-1]
    emit({"phase": "robust_main_path", "check": "e_baselines",
          "job": {"A": [wm, wd], "B": [wd, wn]}, "rounds": base_rows})

    # ---- (f) the health snapshot and the adaptive report, JSON
    emit({"phase": "robust_main_path", "check": "f_health_snapshot",
          "defended_trace": health_d, "adaptive_run": health_ad})
    emit({"phase": "robust_main_path", "check": "f_adaptive_report",
          "report": report_ad})
    emit({"phase": "robust_main_path", "check": "phase_total",
          "launches": total, "build_count": _build.build_count,
          "phase_s": time.perf_counter() - phase_t0})
    assert _build.build_count == 1, _build.build_count
    return total


# --------------------------------------------------------------------------
# phase 11: the socket process mesh and the sealed MEA-ECC wire
# --------------------------------------------------------------------------

# (a): the qwen2-7b q|k|v projection of one 512-token prefill chunk, A =
# W_qkv^T (3584 + 512 + 512 rows) @ B (hidden 3584, 512 tokens), Gaussian
SOCKET_JOB = (4608, 3584, 512)
SOCKET_ROUNDS = 3
# paper_fig3's (N, K, T, S): 30 worker processes; a fixed-quantile round
# waits for the N - S = 23 that do not straggle
SOCKET_FIG3 = (30, 24, 3, 7)
# spacing of the replayed arrival order (threads sleep it)
REPLAY_SPACING_S = 0.01
# every mesh's start-up deadline (``TransportSpec.connect_timeout_s``,
# default 60 s): 30 CUDA worker processes on the H100 machine's 8 shared
# cores registered in 34-49 s, and not one of them within 60 s on a host
# that ran phases 7-10 1.5-2x slower; the start time is reported, not
# held
MESH_CONNECT_S = 180.0
# (b i): benchmarks/bench_transport.py's SIGKILL point (fault seed 139 puts
# one crash, worker 1, in round 0 and leaves the retries clean)
KILL_OP = dict(n_workers=6, k_blocks=2, seed=7, fault_seed=139,
               crash_rate=0.25, max_retries=3, worker_timeout_s=1.5)
# (b ii): bench_faults' point with drops (tampered frames) added
MESH_FAULT_ROUNDS = 2
MESH_DROP_RATE = 0.12
# (b)'s respawns per worker.  (b) runs at TransportSpec's default liveness
# deadline, as (a) and (c) do.  While SIGKILLed CUDA workers are torn down
# and respawned, a live worker's frames have come 16.09 and 39.78 s apart
# on the card: the mesh writes it off, and (b ii)'s simulated run is told
# so (replay_write_offs)
MESH_MAX_RESPAWNS = 8
# (b ii)'s stall probe: each worker process dumps every thread's stack
# once it has sent no frame for this long (launch/worker.py), into
# build/stall_dumps/ (the dumps' text also goes into the phase's row)
STALL_DUMP_S = 5.0
# (c): phase 9 (e)'s workload with gen cut from 4 to 2 (5 steps, not 7): at
# 4 the phase took 85.34-95.49 s on the card, past its 90 s budget; the
# tokens are held against the first 2 of each of phase 9 (e)'s requests
SOCKET_SERVE_GEN = 2


class ReplayStraggler:
    """A straggler model that replays recorded arrival orders: in round
    (or retry round index) ``r``, worker ``orders[r][i]`` is delayed ``i *
    spacing_s`` and the workers missing from it come after all of them, so
    the virtual clock and real threads consume the responders a socket
    round consumed.  ``orders`` maps round indices to orders; a plain list
    is every round's."""

    def __init__(self, n_workers: int, n_stragglers: int, orders,
                 spacing_s: float = REPLAY_SPACING_S):
        self.n_workers, self.n_stragglers = n_workers, n_stragglers
        self._orders = orders
        self._spacing = spacing_s

    def delays(self, round_idx: int):
        import numpy as np
        order = (self._orders.get(int(round_idx), [])
                 if isinstance(self._orders, dict) else self._orders)
        rank = {int(w): i for i, w in enumerate(order)}
        return np.asarray([rank.get(w, len(order) + w) * self._spacing
                           for w in range(self.n_workers)], np.float64)


def record_arrival_orders(mesh, orders: dict,
                          written_off: dict = None) -> None:
    """Record, per round index the mesh is handed (retries have their
    own), the workers in the order the engine consumed their arrivals and
    (into ``written_off``) those the liveness deadline wrote off."""
    submit = mesh.submit_round

    def recorded(shards, f, round_idx, **kw):
        handle = submit(shards, f, round_idx, **kw)
        if written_off is not None:
            written_off[int(round_idx)] = handle.written_off
        order = orders.setdefault(int(round_idx), [])
        events = handle.events

        def consumed():
            for ev in events():
                order.append(ev.worker)
                yield ev
        handle.events = consumed
        return handle
    mesh.submit_round = recorded


def socket_spec(backend: str, *, encrypt=None, **transport):
    """``ClusterSpec.paper_fig3()`` (N=30, K=24, T=3, S=7) on ``backend``;
    the virtual clock runs the loop round (``fused=False``), as a real
    transport does."""
    from repro_torch.api import ClusterSpec, CryptoSpec, TransportSpec
    spec = ClusterSpec.paper_fig3()
    return dataclasses.replace(
        spec, crypto=CryptoSpec(encrypt=encrypt),
        transport=TransportSpec(backend=backend,
                                connect_timeout_s=MESH_CONNECT_S,
                                **transport),
        code=dataclasses.replace(
            spec.code, fused=False if backend == "virtual" else None))


def worker_maps(mesh) -> dict:
    """Per live worker: whether ``/proc/<pid>/maps`` has ``libcuda``, i.e.
    whether the process made a CUDA context.  (Which path its tasks took is
    what their RESULTs report: ``record_round_handles``.)"""
    return {w: "libcuda" in Path(f"/proc/{mesh.worker_pid(w)}/maps")
            .read_text() for w in range(mesh.n)}


def record_round_handles(mesh) -> list:
    """Keep every round handle the mesh hands out, in order, in the list
    returned: after a round, ``handle.worker_launches[w]`` is the kernel
    launches worker ``w``'s RESULT reported for its task."""
    handles = []
    submit = mesh.submit_round

    def recorded(*args, **kw):
        handle = submit(*args, **kw)
        handles.append(handle)
        return handle
    mesh.submit_round = recorded
    return handles


def responder_launches(handle, st) -> dict:
    """The kernel launches each consumed responder of a round reported."""
    return {w: handle.worker_launches.get(w)
            for _, w in st.arrivals[:st.n_waited]}


def hold_sealed_round(torch, engine, b):
    """Hold every ``mask_add`` call of one sealed mesh round of ``engine``
    (the loop round with ``encrypt="real"`` on the socket mesh): the
    master's seal and open calls one by one against the plain version
    (``hold_ops_mask_adds``), and each responder's open and seal through the
    reply it sent.  The plain version opens the sealed shard the worker was
    sent with the worker's key pair, multiplies (by ``b``, or the pair) and
    seals the product to the master under the reply nonce the master drew;
    the worker's ciphertext must be that, limb for limb.  So the worker's
    open, product and seal were all exact, and it replied under the nonce
    it was given (an open that hands back the product does not show that:
    a reply carries its own nonce).  Returns ``(undo, check)``;
    ``check()`` returns the counts and flags the caller asserts.  The plain
    versions launch no kernel."""
    mea = engine._mea
    plain = mea.to(mea.device)
    plain.use_kernel = False
    kps, master = engine._worker_kps, engine._master_kp
    rounds, masks = [], []
    run = engine._loop_round

    def loop_round(shards, f, *args, **kw):
        out = run(shards, f, *args, **kw)
        rounds.append((list(shards), out[0], out[1]))
        return out
    engine._loop_round = loop_round
    undo_masks = hold_ops_mask_adds(torch, masks)

    def undo():
        engine._loop_round = run
        undo_masks()

    def check() -> dict:
        replies = exact = 0
        for shards, resp, results in rounds:
            for w, ct in zip(resp, results):
                _, cts, reply_nonce = shards[w]
                parts = [plain.decrypt(c, kps[w]) for c in cts]
                prod = torch.matmul(parts[0], parts[1] if len(parts) == 2
                                    else b)
                want = plain.encrypt(prod, master.pk, sender=kps[w],
                                     nonce=reply_nonce)
                replies += 1
                exact += (ct.nonce == reply_nonce and
                          ct.ephemeral == kps[w].pk and
                          tuple(ct.shape) == tuple(want.shape) and
                          torch.equal(ct.payload.view(torch.int32),
                                      want.payload.view(torch.int32)))
        return {"master_calls": len(masks),
                "master_calls_exact": sum(ok for *_, ok in masks),
                "master_shapes": sorted({shape for shape, *_ in masks}),
                "rounds": len(rounds),
                "shards_sealed": sum(len(sh) for sh, _, _ in rounds),
                "worker_replies": replies, "worker_replies_exact": exact}
    return undo, check


def silences(mesh, t0: float) -> list:
    """The mesh's gaps of a second or more between two frames of one
    connection: [worker, seconds from ``t0`` to the gap's end, gap]."""
    return [[w, end - t0, gap] for w, end, gap in mesh.silences]


def mesh_counters(mesh) -> dict:
    keys = ("bytes_sent", "bytes_received", "frame_s", "unframe_s",
            "frames_sent", "frames_received")
    return {k: mesh.stats.get(k, 0) for k in keys}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def replay_round(torch, backend: str, st, a, b, round_idx: int):
    """The same round on ``backend`` (the virtual loop round or threads),
    fed the socket round's arrival order: the same responders."""
    from repro_torch.runtime.engine import RoundEngine
    spec = socket_spec(backend)
    order = [w for _, w in st.arrivals]
    eng = RoundEngine(spec, device=a.device, straggler=ReplayStraggler(
        spec.code.n_workers, spec.straggler.n_stragglers, order))
    try:
        return eng.matmul(a, b, round_idx=round_idx)
    finally:
        eng.close()


def replay_write_offs(written_off: dict):
    """Make the seeded fault plan of round index ``r`` also crash the
    workers in ``written_off[r]``: the live workers a mesh round wrote off
    at its liveness deadline, which never arrive in that round, as a
    crashed worker never does.  A simulated run fed these and the mesh's
    arrival orders sees the round the mesh saw.  Returns the undo."""
    from repro_torch.runtime import faults
    real = faults.plan_faults

    def plan_faults(fault, seed, round_idx, n):
        plan = real(fault, seed, round_idx, n)
        off = [w for w in written_off.get(int(round_idx), ()) if w < n]
        if not off:
            return plan
        crash = plan.crash.copy()
        crash[off] = True
        return dataclasses.replace(plan, crash=crash,
                                   drop=plan.drop & ~crash,
                                   corrupt=plan.corrupt & ~crash)
    faults.plan_faults = plan_faults

    def undo():
        faults.plan_faults = real
    return undo


def fixed_health_latency(latency_s: float = 1e-3):
    """Make every ``WorkerHealth.record_ok`` record ``latency_s``; returns
    the undo.  The defended round ranks re-dispatch candidates by their
    measured latency, which the mesh and threads measure differently; the
    comparison of (b ii) fixes it in both runs, as the parity tests fix the
    compute time."""
    from repro_torch.runtime.faults import WorkerHealth
    real = WorkerHealth.record_ok

    def record_ok(self, worker, measured_s):
        return real(self, worker, latency_s)
    WorkerHealth.record_ok = record_ok

    def undo():
        WorkerHealth.record_ok = real
    return undo


def stall_dumps(folder: Path) -> dict:
    """The stall probe's dumps: {file: the first dump's text} for every
    worker process that went ``STALL_DUMP_S`` without sending a frame
    (``faulthandler`` writes "Thread 0x..." headers, the current thread
    first, then each thread's frames innermost first)."""
    out = {}
    for path in sorted(folder.glob("worker*.txt")):
        text = path.read_text(errors="replace")
        if text.strip():
            out[path.name] = {"dump_lines": text.count("\n"),
                              "first_dump": text[:4000]}
    return out


def socket_main_path(torch, dev, serve_tokens=None) -> dict:
    """Phase 11: the socket mesh of worker processes on the card, and the
    sealed MEA-ECC wire.  (a) three plain and three sealed loop rounds
    under ``paper_fig3()`` at the qwen2-7b q|k|v job, 30 worker processes
    on the card: each round bit-identical to the virtual loop round (and
    round 0 to real threads) fed its arrival order, within 1e-4 of the
    kernels-off decode of its responders, every responder's task reporting
    its own kernel launches (two ``mask_add`` sealed, none plain), a held
    round's ``berrut_combine`` calls within float32's bound and, sealed,
    its every ``mask_add`` call exact (``hold_sealed_round``: the master's
    calls one by one, the workers' through their replies), no live worker
    written off at ``TransportSpec``'s default liveness deadline, every
    worker with ``libcuda`` mapped, mesh start, wire bytes, framing seconds, device
    memory and a bounded close; (b) OS-level faults: (i)
    bench_transport's SIGKILL point (real kills, respawns, the defended
    decode equal to the plan simulated on threads), (ii) bench_faults'
    point with drops (the exclusions and the decode equal to threads fed
    the mesh's arrival orders and liveness write-offs);
    (c) phase 9 (e)'s serve over the mesh with gen cut to
    ``SOCKET_SERVE_GEN``, its tokens equal to the first ones of phase 9
    (e)'s threads tokens (``serve_tokens["e_threads"]``; served here on
    threads first when not given, as when phase 11 runs alone).  Returns
    the master's counted launches (worker processes count their own and
    report them in their RESULTs).
    Phase 11 alone: ``build_kernels(torch)`` then ``socket_main_path(torch,
    torch.device("cuda"))``."""
    import gc
    import statistics

    import numpy as np
    from repro_torch.api import (ClusterSpec, CodeSpec, FaultSpec,
                                 PrivacySpec, ServeSpec, Session,
                                 StragglerSpec, TransportSpec, WaitSpec)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.runtime import wire
    from repro_torch.runtime.serve_loop import poisson_workload
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ---- (a) plain and sealed loop rounds, 30 worker processes
    m, d, n_out = SOCKET_JOB
    a = gaussian(torch, dev, (m, d), 60)
    b = gaussian(torch, dev, (d, n_out), 61)
    exact = f64_product(torch, a, b)
    exact_norm = float(torch.linalg.vector_norm(exact))
    plain_scheme = _use_plain(socket_spec("socket")).build_scheme()
    n_workers, _, _, n_slow = SOCKET_FIG3
    for encrypt in (None, "real"):
        spec = socket_spec("socket", encrypt=encrypt)
        assert (spec.code.n_workers, spec.code.k_blocks,
                spec.privacy.t_colluding, spec.straggler.n_stragglers) == \
            SOCKET_FIG3
        wire_name = "sealed" if encrypt else "plain"
        free()
        dev_used0 = torch.cuda.mem_get_info(dev)
        s = Session(spec, device=dev)
        try:
            mesh = s.engine.pool.transport
            t_mesh = t0 = time.perf_counter()
            mesh.start()
            start_s = time.perf_counter() - t0
            handles = record_round_handles(mesh)
            free_b, total_b = torch.cuda.mem_get_info(dev)
            mem = {"device_used_gb_before": (dev_used0[1] - dev_used0[0])
                   / 1e9,
                   "device_used_gb_with_mesh": (total_b - free_b) / 1e9,
                   "master_allocated_gb": torch.cuda.memory_allocated(dev)
                   / 1e9}
            mem["per_worker_context_gb"] = (
                mem["device_used_gb_with_mesh"] -
                mem["device_used_gb_before"]) / n_workers
            t_comp = s.engine._round_compute_time(a.shape, b.shape)[1]
            rows = []
            for r in range(SOCKET_ROUNDS):
                c0 = mesh_counters(mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (out, st), launched = counted(
                    kernels, total, lambda: s.matmul(a, b, round_idx=r))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                io = counter_delta(c0, mesh_counters(mesh))
                vout, vst = replay_round(torch, "virtual", st, a, b, r)
                want = threads_plain_decode(torch, plain_scheme, a, b, st)
                torch.cuda.synchronize()
                resp = sorted(w for _, w in st.arrivals[:st.n_waited])
                vresp = sorted(w for _, w in vst.arrivals[:vst.n_waited])
                delays = s.engine.straggler.delays(r)
                plan_resp = sorted(np.argsort(delays + t_comp,
                                              kind="stable")[:st.n_waited]
                                   .tolist())
                lag = [t - (float(delays[w]) + t_comp)
                       for t, w in st.arrivals]
                # a sealed task opens its shard and seals its product: two
                # mask_add launches in the worker; a plain task launches none
                w_launches = responder_launches(handles[-1], st)
                err, rel = rel_diff(torch, out, want)
                rel_x = rel_to(torch, out, exact, exact_norm)
                row = {"phase": "socket_main_path",
                       "check": f"a_{wire_name}_round", "round": r,
                       "A": [m, d], "B": [d, n_out],
                       "n_waited": st.n_waited, "responders": resp,
                       "same_responders_as_spec_virtual_plan":
                           resp == plan_resp,
                       "bit_identical_to_virtual_replay":
                           bool(torch.equal(out, vout)),
                       "virtual_replay_responders_equal": resp == vresp,
                       "vs_plain_decode_max_abs": err,
                       "vs_plain_decode_rel": rel,
                       "rel_err_vs_f64": rel_x,
                       "round_wall_s": wall_s, "encode_s": st.encode_s,
                       "crypto_s": st.crypto_s, "decode_s": st.decode_s,
                       "compute_wait_s": st.compute_wait_s,
                       "arrival_lag_behind_virtual_clock_ms": {
                           "median": 1e3 * statistics.median(lag),
                           "max": 1e3 * max(lag)},
                       "wire": io, "launches": launched,
                       "worker_launches_per_responder": sorted(
                           {json.dumps(v) for v in w_launches.values()}),
                       "dispatches": st.dispatches}
                if r == 0:
                    tout, tst = replay_round(torch, "threads", st, a, b, r)
                    row["bit_identical_to_threads_replay"] = bool(
                        torch.equal(out, tout))
                    row["threads_replay_responders"] = sorted(
                        w for _, w in tst.arrivals[:tst.n_waited])
                    del tout
                emit(row)
                rows.append(row)
                assert out.device == a.device and out.shape == (m, n_out)
                assert bool(torch.isfinite(out).all()), row
                assert st.n_waited == n_workers - n_slow, row
                assert resp == vresp, row
                assert row["bit_identical_to_virtual_replay"], row
                if r == 0:
                    assert row["bit_identical_to_threads_replay"], row
                    assert row["threads_replay_responders"] == resp, row
                assert rel <= ROUND_TOL, row
                assert launched["berrut_combine"] == 2, row
                assert launched["coded_matmul"] == \
                    launched["flash_attention"] == 0, row
                assert all(v == ({"mask_add": 2} if encrypt else {})
                           for v in w_launches.values()), row
                if encrypt:
                    # one mask_add per shard sealed and per result opened;
                    # a session's first round adds the cipher's rate probe
                    probe = 4 if r == 0 else 0
                    assert launched["mask_add"] == \
                        n_workers + st.n_waited + probe, row
                    assert st.crypto_s > 0, row
                else:
                    assert launched["mask_add"] == 0, row
                    assert st.crypto_s == 0, row
                del out, vout, want
            maps = worker_maps(mesh)
            # one more round with every berrut_combine call held and, sealed,
            # every mask_add call of the master and the workers (outside the
            # timed rounds: the float64 bound is not the round's work)
            ratios = []
            hold_combines(torch, s.engine.scheme, ratios)
            undo_seal, check_seal = (hold_sealed_round(torch, s.engine, b)
                                     if encrypt else (lambda: None, dict))
            try:
                (out, st), launched = counted(
                    kernels, total,
                    lambda: s.matmul(a, b, round_idx=SOCKET_ROUNDS))
            finally:
                undo_seal()
            held = {"calls": len(ratios), "worst_bound_ratio": max(ratios),
                    "mask_add": check_seal(), "n_waited": st.n_waited}
            del out
            if encrypt:
                ct = s.engine._mea.encrypt(
                    torch.zeros((m // 24, d), device=dev),
                    s.engine._worker_kps[0].pk, sender=s.engine._master_kp,
                    nonce=1 << 40)
                enc_b, limb_b = wire.ciphertext_wire_overhead(ct)
                held["ciphertext_wire_overhead_bytes"] = enc_b - limb_b
                del ct
        finally:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.close()
            close_s = time.perf_counter() - t0
        summary = {"phase": "socket_main_path",
                   "check": f"a_{wire_name}_mesh", "workers": n_workers,
                   "mesh_start_s": start_s, "close_s": close_s,
                   "join_timeout_s": mesh.join_timeout_s,
                   "liveness_timeout_s": mesh.liveness_timeout_s,
                   "liveness_expired": mesh.stats["liveness_expired"],
                   "max_silence_s": mesh.stats["max_silence_s"],
                   "silences": silences(mesh, t_mesh),
                   "memory": mem, "held": held,
                   "workers_with_libcuda": sum(maps.values()),
                   "mesh_stats": dict(mesh.stats),
                   "build_count": _build.build_count,
                   "t_compute_virtual_s": t_comp}
        emit(summary)
        assert all(maps.values()), summary
        assert held["calls"] == 2 and held["worst_bound_ratio"] <= 1.0, \
            summary
        # TransportSpec's default liveness deadline: no live worker is
        # written off
        assert summary["liveness_expired"] == 0, summary
        seal = held["mask_add"]
        if encrypt:
            rows_k = m // SOCKET_FIG3[1]
            assert seal["master_calls"] == seal["master_calls_exact"] == \
                n_workers + held["n_waited"], summary
            assert [[rows_k * d, 8], [rows_k * n_out, 8]] == sorted(
                [list(x) for x in seal["master_shapes"]], reverse=True), \
                summary
            assert seal["rounds"] == 1, summary
            assert seal["shards_sealed"] == n_workers, summary
            assert seal["worker_replies"] == seal["worker_replies_exact"] \
                == held["n_waited"], summary
            assert held["ciphertext_wire_overhead_bytes"] < 256, summary
        assert close_s <= mesh.join_timeout_s + 1.5, summary
        assert all(p.poll() is not None for p in mesh._procs.values())
        assert _build.build_count == 1, _build.build_count
        del s
    # the sealed rounds decode the plain rounds' bits: each matched the
    # plain virtual loop round of its own responders
    free()

    # ---- (b i) bench_transport's SIGKILL point, real kills
    def kill_spec(backend):
        op = KILL_OP
        return ClusterSpec(
            code=CodeSpec(scheme="spacdc", n_workers=op["n_workers"],
                          k_blocks=op["k_blocks"]),
            straggler=StragglerSpec(n_stragglers=0, delay_s=0.02),
            transport=TransportSpec(backend=backend, heartbeat_s=0.1,
                                    max_respawns=MESH_MAX_RESPAWNS,
                                    connect_timeout_s=MESH_CONNECT_S),
            fault=FaultSpec(crash_rate=op["crash_rate"], handle=True,
                            os_level=backend == "socket",
                            seed=op["fault_seed"],
                            worker_timeout_s=op["worker_timeout_s"],
                            max_retries=op["max_retries"]),
            seed=op["seed"])

    def mesh_run(spec, rounds: int, orders=None, offs=None):
        """``rounds`` rounds of ``spec`` on one engine; returns (outputs,
        stats, mesh stats, per round with a kill the seconds from its
        start until every worker is registered again (kills land at its
        dispatch), health snapshot).  On the mesh the consumed arrival
        orders go to ``orders`` and the liveness write-offs to ``offs``;
        on threads, given, they are replayed (``ReplayStraggler``,
        ``replay_write_offs``)."""
        from repro_torch.runtime.engine import RoundEngine
        on_mesh = spec.transport.backend == "socket"
        outs, stats, whole_s = [], [], []
        straggler = None
        if orders is not None and not on_mesh:
            straggler = ReplayStraggler(spec.code.n_workers,
                                        spec.straggler.n_stragglers, orders)
        eng = RoundEngine(spec, device=dev, straggler=straggler)
        undo = (replay_write_offs(offs) if offs is not None and not on_mesh
                else (lambda: None))
        try:
            mesh = eng.pool.transport
            t_mesh = time.perf_counter()
            if on_mesh:
                mesh.start()
                if orders is not None:
                    record_arrival_orders(mesh, orders, offs)
            for r in range(rounds):
                kills = mesh.stats["kills"] if on_mesh else 0
                t0 = time.perf_counter()
                (out, st), _ = counted(kernels, total,
                                       lambda: eng.matmul(a, b, round_idx=r))
                outs.append(out)
                stats.append(st)
                if on_mesh and mesh.stats["kills"] > kills:
                    mesh.start()            # waits for the respawns
                    whole_s.append(time.perf_counter() - t0)
            ms = (dict(mesh.stats, silences=silences(mesh, t_mesh))
                  if on_mesh else {})
            health = eng.health.snapshot()
        finally:
            undo()
            eng.close()
        return outs, stats, ms, whole_s, health

    free()
    outs_k, st_k, ms_k, respawn_k, health_k = mesh_run(
        kill_spec("socket"), 1)
    outs_t, st_t, _, _, _ = mesh_run(kill_spec("threads"), 1)
    out, st = outs_k[0], st_k[0]
    rel_x = rel_to(torch, out, exact, exact_norm)
    row = {"phase": "socket_main_path", "check": "b_i_sigkill",
           "spec": KILL_OP, "A": [m, d], "B": [d, n_out],
           "kills": ms_k.get("kills", 0), "respawns": ms_k.get("respawns", 0),
           "worker_deaths": ms_k.get("worker_deaths", 0),
           "retries": st.retries, "degraded": st.degraded,
           "decode_mask": st.decode_mask, "rel_err_vs_f64": rel_x,
           "bit_identical_to_simulated_threads": bool(
               torch.equal(out, outs_t[0])),
           "threads_retries": st_t[0].retries,
           "round_start_to_mesh_whole_s": respawn_k,
           "liveness_timeout_s": TransportSpec().liveness_timeout_s,
           "liveness_expired": ms_k.get("liveness_expired", 0),
           "max_silence_s": ms_k.get("max_silence_s", 0.0),
           "silences": ms_k.get("silences", []),
           "compute_wait_s": st.compute_wait_s, "encode_s": st.encode_s,
           "decode_s": st.decode_s,
           "crashed_in_health": [w for w, n in enumerate(
               health_k.get("n_crash", [])) if n]}
    emit(row)
    assert row["kills"] >= 1 and row["respawns"] >= 1, row
    assert st.retries >= 1 and not st.degraded, row
    assert rel_x <= DEFENDED_REL_MAX, row
    assert row["bit_identical_to_simulated_threads"], row
    del outs_k, outs_t, out
    free()

    # ---- (b ii) bench_faults' point with drops, OS-level
    def faults_spec(backend):
        spec = fault_spec(handle=True)
        return dataclasses.replace(
            spec, transport=TransportSpec(backend=backend, heartbeat_s=0.1,
                                          max_respawns=MESH_MAX_RESPAWNS,
                                          connect_timeout_s=MESH_CONNECT_S),
            fault=dataclasses.replace(spec.fault, drop_rate=MESH_DROP_RATE,
                                      os_level=backend == "socket"))

    orders, offs = {}, {}
    stall_dir = ROOT / "build" / "stall_dumps"
    shutil.rmtree(stall_dir, ignore_errors=True)
    undo = fixed_health_latency()
    try:
        os.environ["SPACDC_WORKER_STALL_DUMP"] = f"{STALL_DUMP_S}:{stall_dir}"
        try:
            outs_s, st_s, ms_s, respawn_s, _ = mesh_run(
                faults_spec("socket"), MESH_FAULT_ROUNDS, orders=orders,
                offs=offs)
        finally:
            del os.environ["SPACDC_WORKER_STALL_DUMP"]
        outs_t, st_t, _, _, _ = mesh_run(faults_spec("threads"),
                                         MESH_FAULT_ROUNDS, orders=orders,
                                         offs=offs)
        outs_o, st_o, _, _, _ = mesh_run(faults_spec("threads"),
                                         MESH_FAULT_ROUNDS)
    finally:
        undo()
    rounds = []
    for r in range(MESH_FAULT_ROUNDS):
        o_s, o_t, s_s, s_t = outs_s[r], outs_t[r], st_s[r], st_t[r]
        rounds.append({
            "round": r, "excluded": list(s_s.excluded),
            "threads_excluded": list(s_t.excluded),
            "retries": s_s.retries, "threads_retries": s_t.retries,
            "degraded": s_s.degraded, "decode_mask": s_s.decode_mask,
            "decode_mask_equal": s_s.decode_mask == s_t.decode_mask,
            "bit_identical_to_simulated_threads": bool(torch.equal(o_s,
                                                                   o_t)),
            "equal_to_threads_on_its_own_arrivals": bool(
                torch.equal(o_s, outs_o[r])),
            "threads_own_decode_mask": st_o[r].decode_mask,
            "rel_err_vs_f64": rel_to(torch, o_s, exact, exact_norm),
            "compute_wait_s": s_s.compute_wait_s})
    op = dict(FAULT_OP, drop_rate=MESH_DROP_RATE)
    row = {"phase": "socket_main_path", "check": "b_ii_os_level_faults",
           "spec": op, "A": [m, d], "B": [d, n_out], "rounds": rounds,
           "kills": ms_s.get("kills", 0),
           "crc_failures": ms_s.get("crc_failures", 0),
           "respawns": ms_s.get("respawns", 0),
           "liveness_timeout_s": TransportSpec().liveness_timeout_s,
           "liveness_expired": ms_s.get("liveness_expired", 0),
           "written_off_by_liveness": {str(k): v for k, v in
                                       sorted(offs.items()) if v},
           "max_silence_s": ms_s.get("max_silence_s", 0.0),
           "round_start_to_mesh_whole_s": respawn_s,
           "consumed_arrival_orders": {str(k): v for k, v in
                                       sorted(orders.items())},
           "health_latency_fixed_s": 1e-3, "mesh_stats": ms_s}
    emit(row)
    emit({"phase": "socket_main_path", "check": "b_ii_stall_dumps",
          "after_silent_s": STALL_DUMP_S, "dir": str(stall_dir),
          "dumps": stall_dumps(stall_dir)})
    for rr in rounds:
        assert rr["excluded"] == rr["threads_excluded"], row
        assert rr["retries"] == rr["threads_retries"], row
        assert rr["decode_mask_equal"], row
        assert rr["bit_identical_to_simulated_threads"], row
    assert row["kills"] >= 1 and row["crc_failures"] >= 1, row
    del outs_s, outs_t, outs_o, a, b, exact
    free()

    # ---- (c) phase 9 (e)'s serve over the mesh, full width
    cfg = get_config(SERVE_ARCH)
    reqs = poisson_workload(2, rate_rps=0.0, prompt_len=4, gen=4,
                            vocab=cfg.vocab_size, seed=0, ragged=False)
    cut = poisson_workload(2, rate_rps=0.0, prompt_len=4,
                           gen=SOCKET_SERVE_GEN, vocab=cfg.vocab_size,
                           seed=0, ragged=False)

    def serve_spec(backend):
        # phase 9 (e)'s exact spec: mds N=8, K=4, all 8 waited for
        return ClusterSpec(
            code=CodeSpec(scheme="mds", n_workers=8, k_blocks=4),
            wait=WaitSpec(policy="first_k", k=8),
            straggler=StragglerSpec(n_stragglers=0),
            transport=TransportSpec(backend=backend,
                                    connect_timeout_s=MESH_CONNECT_S),
            serve=ServeSpec(coded_layers="unembed", max_slots=8))
    serve_tokens = {} if serve_tokens is None else serve_tokens
    if "e_threads" not in serve_tokens:
        with Session(serve_spec("threads"), device=dev) as s:
            rep = s.serve(arch=SERVE_ARCH, tiny=False, requests=reqs,
                          check_agreement=False)
        serve_tokens["e_threads"] = [r.tokens for r in rep.requests]
        del s, rep
        free()
    t_phase = time.perf_counter()
    s = Session(serve_spec("socket"), device=dev)
    try:
        mesh = s.engine.pool.transport
        mesh.start()
        c0 = mesh_counters(mesh)
        rep, launched = counted(kernels, total, lambda: s.serve(
            arch=SERVE_ARCH, tiny=False, requests=cut,
            check_agreement=False))
        io = counter_delta(c0, mesh_counters(mesh))
        maps = worker_maps(mesh)
    finally:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.close()
        close_s = time.perf_counter() - t0
    serve_s = time.perf_counter() - t_phase
    walls = float(np.sum(rep.step_wall_s))
    same = all(np.array_equal(r.tokens, t[:SOCKET_SERVE_GEN])
               for r, t in zip(rep.requests, serve_tokens["e_threads"]))
    row = {"phase": "socket_main_path", "check": "c_serve_over_mesh",
           **serve_summary(rep), "gen": SOCKET_SERVE_GEN,
           "tokens_equal_phase9_e_threads_prefix": same,
           "wire": io, "framing_share_of_step_wall":
               io["frame_s"] / max(walls, 1e-12),
           "step_wall_s": [float(w) for w in rep.step_wall_s],
           "bytes_sent_per_step": io["bytes_sent"] / max(len(
               rep.step_stats), 1),
           "launches": launched, "close_s": close_s,
           "join_timeout_s": mesh.join_timeout_s, "phase_c_s": serve_s,
           "liveness_timeout_s": mesh.liveness_timeout_s,
           "liveness_expired": mesh.stats["liveness_expired"],
           "max_silence_s": mesh.stats["max_silence_s"],
           "silences": silences(mesh, t_phase),
           "worker_launches": {k: v for k, v in mesh.stats.items()
                               if k.startswith("worker_launches_")},
           "workers_with_libcuda": sum(maps.values())}
    emit(row)
    assert rep.mode == "round" and same, row
    assert all(maps.values()), row
    assert close_s <= mesh.join_timeout_s + 1.5, row
    del s, rep
    free()

    emit({"phase": "socket_main_path", "check": "phase_total",
          "launches_master": total, "build_count": _build.build_count,
          "phase_s": time.perf_counter() - phase_t0})
    assert _build.build_count == 1, _build.build_count
    return total


# --------------------------------------------------------------------------
# phase 12: DeepSeek-V2's multi-head latent attention and the MoE FFN
# --------------------------------------------------------------------------

DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
# MLA's prefill attention at full width: B, S, H, KV (= H), hd (nope 128
# + rope 64), hd_v; causal
MLA_FLASH = (1, 4096, 16, 16, 192, 128)
# the room phase 12 asks of the card before it builds the full model: its
# peak, 77.13 GB on the H100 while serving "all" (15.71 B float32
# parameters, 62.83 GB; 4.74 GB of shards, 2 x 592 M coded weights; the
# unembed's encode held against its plain version, 2 x 1.68 GB; one
# layer's bfloat16 expert casts, 1.1 GB), and a margin
DEEPSEEK_ROOM_GB = 78.0
DEEPSEEK_SERVE = dict(batch=4, prompt_len=6, gen=6)
DEEPSEEK_TF_STEPS = 8
# the forward's device time by kernel class: MoE routing's dispatch and
# combine are index, gather, scatter, cumsum and top-k kernels (the
# embedding's one gather lands there too)
DEEPSEEK_CLASSES = (("flash_attention", ("flash_fwd",)),
                    ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                    ("moe_dispatch_combine", ("index", "gather", "scatter",
                                              "cumsum", "scan", "topk",
                                              "sort", "radix")),
                    ("casts", ("copy_kernel",)))


def record_routes():
    """Make every MoE router call of the process also append its top-k
    expert indices to the returned list.  Returns (the list, the function
    that undoes it)."""
    from repro_torch.models import moe
    routes, run = [], moe._router

    def router(p, x, cfg):
        out = run(p, x, cfg)
        routes.append(out[1])
        return out
    moe._router = router

    def undo():
        moe._router = run
    return routes, undo


def replay_routes(torch, routes: list):
    """Make the MoE router calls of the process take their top-k experts
    from ``routes`` (a recorded run's, call by call) and their weights
    from their own probabilities at those experts, renormalised as the
    router does; the load-balance and z losses stay their own.  With the
    same experts, capacity drops the same choices.  Returns the function
    that undoes it (and checks that every recorded call was replayed)."""
    from repro_torch.models import moe
    run, queue = moe._router, list(routes)

    def router(p, x, cfg):
        _, _, lb, z = run(p, x, cfg)
        idx = queue.pop(0)
        probs = torch.softmax(x.to(torch.float32)
                              @ p["router"].to(torch.float32), dim=-1)
        w = probs.gather(-1, idx)
        return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9), idx, lb, z
    moe._router = router

    def undo():
        moe._router = run
        assert not queue, f"{len(queue)} recorded router calls not replayed"
    return undo


def capture_layers(model):
    """Forward hooks keeping every layer's (input, output) hidden state of
    the next forwards, in layer order.  Returns (the list, the function
    that removes the hooks)."""
    kept = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: kept.append((args[0], out[0])))
        for layer in model.layers]

    def undo():
        for h in hooks:
            h.remove()
    return kept, undo


def other_experts(torch, routes_a: list, routes_b: list):
    """(B, S) bool: the positions that some layer routed to another set of
    experts in run a than in run b."""
    assert len(routes_a) == len(routes_b) and routes_a
    differ = torch.zeros(routes_a[0].shape[:-1], dtype=torch.bool,
                         device=routes_a[0].device)
    for ra, rb in zip(routes_a, routes_b):
        differ |= (ra.sort(dim=-1).values
                   != rb.sort(dim=-1).values).any(dim=-1)
    return differ


def logits_rel(torch, got, want, keep=None, chunk: int = 512) -> dict:
    """max |got - want| over max |want| of (B, S, V) logits, over all
    positions and over the ``keep`` (B, S) ones (default: all), in float32
    chunks of positions; and the argmax agreement over both."""
    if keep is None:
        keep = torch.ones(got.shape[:2], dtype=torch.bool,
                          device=got.device)
    den = num_all = num_keep = 0.0
    same_all = same_keep = 0
    for s0 in range(0, got.shape[1], chunk):
        g = got[:, s0:s0 + chunk].float()
        w = want[:, s0:s0 + chunk].float()
        k = keep[:, s0:s0 + chunk]
        den = max(den, float(w.abs().max()))
        d = (g - w).abs().amax(dim=-1)
        num_all = max(num_all, float(d.max()))
        if bool(k.any()):
            num_keep = max(num_keep, float(d[k].max()))
        same = g.argmax(-1) == w.argmax(-1)
        same_all += int(same.sum())
        same_keep += int((same & k).sum())
    n, n_keep = keep.numel(), int(keep.sum())
    return {"rel_all": num_all / den, "rel_same_experts": num_keep / den,
            "positions": n, "positions_same_experts": n_keep,
            "argmax_agreement": same_all / n,
            "argmax_agreement_same_experts": same_keep / max(n_keep, 1)}


def check_model_flash(torch, gen, dev, shape: tuple, phase: str,
                      check: str, *, skv: int | None = None,
                      causal: bool = True) -> dict:
    """The flash kernel at a model's prefill shape (``shape`` = B, S, H,
    KV, hd (q . k), hd_v; ``skv`` keys, default S; causal unless told)
    against its plain version: bfloat16 on the TMA route (contiguous) and
    the plain-load route (views into rows two elements wider), float32 on
    the 3xTF32 route (``check_f32_flash``); each timed beside the plain
    version, with its bound and ``scaled_dot_product_attention`` on the
    same inputs (``enable_gqa`` where KV < H; the backend it picked named
    by its kernels).  Returns the bfloat16 TMA row, the float32 row under
    its "float32"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     load_width)
    b, s, h, kvh, hd, hd_v = shape
    skv = s if skv is None else skv
    head = {"phase": phase, "check": check, "kernel": "flash_attention",
            "shape": {"B": b, "S": s, "Skv": skv, "H": h, "KV": kvh,
                      "hd": hd, "hd_v": hd_v, "causal": causal}}

    def inputs(dt):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                     for shape in ((b, s, h, hd), (b, skv, kvh, hd),
                                   (b, skv, kvh, hd_v)))
    q, k, v = inputs(torch.bfloat16)
    want = ref.mha_reference(q, k, v, causal=causal)
    for route, args in (("tma", (q, k, v)),
                        ("plain_loads", [F.pad(t, (0, 2))[..., :-2]
                                         for t in (q, k, v)])):
        got = flash_attention_kernel(*args, causal=causal)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (b, s, h, hd_v)
        assert bool(torch.isfinite(got.float()).all())
        err, rel = rel_diff(torch, got, want)
        row = dict(head, dtype="bfloat16", route=route,
                   load_width=load_width(*args), max_abs_err=err,
                   rel_err=rel, tol=TOL["bfloat16"])
        if route == "tma":
            row.update(flash_timing(torch, q, k, v, causal))
            nbytes, flops = flash_work(b, s, skv, h, kvh, hd, causal,
                                       q.element_size(), hd_v=hd_v)
            row.update(**bound(nbytes, flops, BF16_TC), flop=flops,
                       bytes=nbytes,
                       tflop_per_s=flops / row["kernel_ms"] / 1e9)
            main = row
        emit(row)
        assert rel <= TOL["bfloat16"], row
        assert route != "plain_loads" or row["load_width"] < 16, row
        del got
    del q, k, v, want
    torch.cuda.empty_cache()
    q, k, v = inputs(torch.float32)
    main["float32"] = check_f32_flash(torch, q, k, v, causal,
                                      dict(head, dtype="float32"))
    del q, k, v
    torch.cuda.empty_cache()
    return main


def flash_timing(torch, q, k, v, causal: bool) -> dict:
    """The flash kernel's time on (q, k, v), the plain version's and
    ``scaled_dot_product_attention``'s on the same inputs (``enable_gqa``
    where KV < H; the backend it picked named by its kernels, or none where
    no backend takes the shape)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    gqa = {"enable_gqa": True} if k.shape[2] < q.shape[2] else {}
    row = {"kernel_ms": timed_ms(torch, lambda: flash_attention_kernel(
               q, k, v, causal=causal)),
           "plain_ms": timed_ms(torch, lambda: ref.mha_reference(
               q, k, v, causal=causal))}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              **gqa)
    try:
        sdpa()
    except RuntimeError as exc:   # no backend takes hd_v != hd
        row.update(library_ms=None, library="none",
                   library_error=repr(exc)[:300])
    else:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sdpa()
            torch.cuda.synchronize()
        names = sorted({e.name[:80] for e in prof.events()
                        if e.device_type == DeviceType.CUDA})
        row.update(library_ms=timed_ms(torch, sdpa),
                   library="F.scaled_dot_product_attention"
                   + ", is_causal" * causal + ", enable_gqa" * bool(gqa),
                   library_kernels=names)
    return row


def plane_bytes(torch, q, k, v) -> int:
    """Bytes the float32 pre-pass must move: q, k and v read once, their
    hi and lo planes (padded as the kernel pads them) written once."""
    from repro_torch.kernels.flash_attention import _plane_sizes
    return 4 * (q.numel() + k.numel() + v.numel() +
                sum(_plane_sizes(q, k, v)))


def check_f32_flash(torch, q, k, v, causal: bool, head: dict,
                    softcap: float = 0.0, timed: bool = True) -> dict:
    """The float32 flash forward (pre-pass + 3xTF32 kernel) on float32 q,
    k, v: the output within TOL of max |plain| and the lse within LSE_TOL
    of max |plain lse|; a second call bit-identical; the pre-pass's planes
    (``f32_planes``) equal to their plain version (``ref.flash_f32_planes``).
    ``timed``: the kernel timed (``flash_timing``), with the pre-pass's and
    the kernel's device time apart, its bound over the 3xTF32 rate and the
    CUDA-core bound beside it, and the pre-pass timed alone beside its
    plain version and its bytes bound.  Emits and returns the row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (f32_planes,
                                                     flash_attention_kernel)
    b, s, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    n0 = flash_attention_kernel.launches
    got, lse = flash_attention_kernel(q, k, v, causal=causal,
                                      softcap=softcap, return_lse=True)
    launched = flash_attention_kernel.launches - n0
    again = flash_attention_kernel(q, k, v, causal=causal, softcap=softcap,
                                   return_lse=True)
    want, lse_p = ref.mha_reference(q, k, v, causal=causal, softcap=softcap,
                                    return_lse=True)
    torch.cuda.synchronize()
    assert launched == 1, launched
    assert got.shape == want.shape == (b, s, h, hd_v)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err, rel = rel_diff(torch, got, want)
    lse_tol = LSE_TOL * max(float(lse_p.abs().max()), 1.0) if skv else 0.0
    row = dict(head, route="3xtf32", max_abs_err=err, rel_err=rel,
               tol=TOL["float32"], lse_tol=lse_tol,
               lse_max_abs_err=float((lse - lse_p).abs().max()) if skv else
               float((lse + 1e30).abs().max()),
               bit_identical_second_call=(torch.equal(got, again[0]) and
                                          torch.equal(lse, again[1])),
               launches=launched)
    del got, lse, again, want, lse_p
    if skv:
        planes = f32_planes(q, k, v)
        pads = (planes[0].shape[2], planes[1].shape[2], planes[0].shape[3],
                planes[2].shape[2])
        plain = ref.flash_f32_planes(q, k, v, pads)
        torch.cuda.synchronize()
        row["split_max_abs_err"] = max(float((x - y).abs().max())
                                       for x, y in zip(planes, plain))
        row["split_equal"] = all(torch.equal(x, y)
                                 for x, y in zip(planes, plain))
        del planes, plain
    if timed:
        row.update(flash_timing(torch, q, k, v, causal))

        def kernel():
            return flash_attention_kernel(q, k, v, causal=causal)
        split = {name: device_ms(torch, kernel, name, calls=10)
                 for name in ("split_rows", "split_vt", "flash_fwd_3xtf32")}
        if split["split_rows"] is not None:   # two launches a call: q, k
            split["split_rows"] *= 2
        row["kernel_split_ms"] = split
        nbytes, flops = flash_work(b, s, skv, h, kvh, hd, causal, 4,
                                   hd_v=hd_v)
        row.update(**bound(nbytes, flops, SPLIT_3XTF32), flop=flops,
                   bytes=nbytes, tflop_per_s=flops / row["kernel_ms"] / 1e9,
                   bound_f32_fma_ms=bound(nbytes, flops,
                                             F32_CUDA)["bound_ms"])
        split_bytes = plane_bytes(torch, q, k, v)
        row["split"] = {
            "ms": timed_ms(torch, lambda: f32_planes(q, k, v)),
            "plain_ms": timed_ms(torch, lambda: ref.flash_f32_planes(
                q, k, v, pads)),
            "max_abs_err": row["split_max_abs_err"],
            "bytes": split_bytes, **bound(split_bytes, 0, HBM)}
    emit(row)
    assert rel <= TOL["float32"], row
    assert row["lse_max_abs_err"] <= row["lse_tol"], row
    assert row["bit_identical_second_call"], row
    assert row.get("split_equal", True), row
    return row


def exact_teacher_forced(torch, model, tokens, tol: float) -> dict:
    """``teacher_forced`` under ``exact_spec("all")``: the model's sites
    encoded, then 8 slots at offsets (0, 1, 2, 0, ...) stepped through
    ``tokens``, the plain step replaying the coded step's experts and a
    third run counting where it would have routed otherwise."""
    from repro_torch.models.coded import (build_coded_step,
                                          encode_serving_weights)
    from repro_torch.runtime.engine import RoundEngine
    engine = RoundEngine(exact_spec("all"), device=tokens.device)
    try:
        code = encode_serving_weights(engine.scheme, model, "all")
        step = build_coded_step(model, engine.scheme, code)
        offsets = torch.arange(8, dtype=torch.int32,
                               device=tokens.device) % 3
        caches = [model.init_cache(8, 24) for _ in range(3)]
        return teacher_forced(torch, model, step, *caches[:2], tokens,
                              offsets, tol, cache_u=caches[2])
    finally:
        engine.close()


def deepseek_main_path(torch, dev) -> dict:
    """Phase 12: deepseek-v2-lite-16b (27 layers, MLA in each, a MoE FFN
    of 64 routed experts, top 6, and 2 shared in layers 1-26) at full
    width and depth on the card.  (a) the flash kernel at MLA's prefill
    shape (hd 192, hd_v 128) against its plain version; (b) the forward on
    1 x 4096 tokens in bfloat16 compute, counted from zero (27 flash
    launches a forward), tokens dropped by capacity per layer, a profiled
    forward; held: every layer's attention through the kernel against the
    plain version on the kernel forward's own input to it (2e-2), and the
    float32-compute forward at full depth against the kernels-off one
    replaying its expert choices (``replay_routes``; 1e-4); measured: the
    bfloat16 logits and each layer's output against the kernels-off
    forward's, replaying or on its own routing; (c) the first 2 layers in
    float32
    compute, ``capacity_factor`` raised so that nothing drops, forward
    against 16 decode steps; (d) ``Session(ClusterSpec.serve_deadline(
    coded_layers="all")).serve`` at full width and depth (MLA's qkv and o
    sites and layer 0's FFN coded, the MoE FFNs not: 57 sites), counted,
    every ``berrut_combine`` call held; on the served code the
    ``encrypt="real"`` step bit-identical to the plain coded step with
    every ``mask_add`` call held; the exact spec's (mds) teacher-forced
    coded logits against the plain step's, the plain step replaying the
    coded step's expert choices, in bfloat16 (measured) and in float32
    compute (phase 9's rule, held).  Returns
    (the counted launches, the MLA flash row).  Phase 12 alone:
    ``build_kernels(torch)`` then ``deepseek_main_path(torch,
    torch.device("cuda"))``."""
    import gc

    import numpy as np
    from repro_torch.api import ClusterSpec, CryptoSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.models import build_model
    from repro_torch.models.attention import mla_forward
    from repro_torch.models.coded import build_coded_step
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.moe import capacity
    from repro_torch.runtime.engine import RoundEngine
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    cfg = get_config(DEEPSEEK_ARCH)
    free_b, total_b = torch.cuda.mem_get_info()
    n_params = cfg.param_count()
    room = {"phase": "deepseek_main_path", "check": "room",
            "free_gb": free_b / 1e9, "card_gb": total_b / 1e9,
            "allocated_here_gb": torch.cuda.memory_allocated() / 1e9,
            "param_count": n_params, "params_gb_float32": 4 * n_params / 1e9,
            "asked_gb": DEEPSEEK_ROOM_GB}
    emit(room)
    assert free_b / 1e9 >= DEEPSEEK_ROOM_GB, \
        f"phase 12 needs {DEEPSEEK_ROOM_GB} GB free on the card: {room}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    # ---- (a) the flash kernel at MLA's prefill shape
    flash_row = check_model_flash(torch, gen, dev, MLA_FLASH,
                                  "deepseek_main_path", "a_mla_flash")
    free()

    # ---- (b) the full-width forward, counted from zero
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)                   # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device=dev)
    want_launch = {"coded_matmul": 0, "berrut_combine": 0, "mask_add": 0,
                   "flash_attention": cfg.n_layers}
    forward_s, drops = [], []
    with torch.inference_mode():
        for r in range(3):
            layer_drops = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            (logits, aux), got = counted(kernels, total, lambda: model(
                tokens, moe_drops=layer_drops))
            torch.cuda.synchronize()
            forward_s.append(time.perf_counter() - t)
            assert got == want_launch, (r, got)
            drops.append([int(n) for n in layer_drops])
        forward_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert tuple(logits.shape) == (1, MODEL_TOKENS, cfg.vocab_size)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())
        lb, z = float(aux["lb_loss"]), float(aux["z_loss"])
        assert np.isfinite(lb) and np.isfinite(z) and lb > 0 and z > 0
        breakdown = profile_device(torch, lambda: model(tokens),
                                   DEEPSEEK_CLASSES)
        del logits
        layers_k, undo_hooks = capture_layers(model)
        routes_k, undo = record_routes()
        try:
            logits, _ = model(tokens)
        finally:
            undo()
            undo_hooks()
        c0 = {k: f.launches for k, f in kernels.items()}
        # the plain attention routing on its own: where it chose other
        # experts than the kernel forward (measured, not held)
        routes_p, undo = record_routes()
        try:
            plain, _ = model(tokens, force_kernel=False)
        finally:
            undo()
        differ = other_experts(torch, routes_k, routes_p)
        own = logits_rel(torch, logits, plain, ~differ)
        del plain, routes_p
        # the plain attention replaying the kernel forward's experts:
        # logits and every layer's output against the kernel forward's
        # (measured: in bfloat16 the two roundings of the attention drift
        # apart layer by layer through the random weights)
        layers_p, undo_hooks = capture_layers(model)
        undo = replay_routes(torch, routes_k)
        try:
            plain, _ = model(tokens, force_kernel=False)
        finally:
            undo()
            undo_hooks()
        cmp_b = logits_rel(torch, logits, plain)
        drift = [rel_diff(torch, k_out, p_out)[1]
                 for (_, k_out), (_, p_out) in zip(layers_k, layers_p)]
        del plain, layers_p
        # held: every layer's attention on the kernel forward's own input
        # to that layer, through the kernel against the plain version
        positions = torch.arange(MODEL_TOKENS, dtype=torch.int32,
                                 device=dev)[None]
        in_situ = []
        for layer, (x_in, _) in zip(model.layers, layers_k):
            h = apply_norm(layer.norm1, x_in, cfg)
            y_k = mla_forward(layer.mixer, h, cfg, positions)
            y_p = mla_forward(layer.mixer, h, cfg, positions,
                              force_kernel=False)
            in_situ.append(rel_diff(torch, y_k, y_p)[1])
        torch.cuda.synchronize()
        plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits, routes_k, layers_k, model
    free()

    # the same weights in float32 compute at full depth: kernel forward
    # against the plain attention replaying its experts (held)
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        seed=0)
    with torch.inference_mode():
        routes_k, undo = record_routes()
        f0 = f32_flash_launches()
        try:
            logits, _ = model(tokens)
        finally:
            undo()
        F32_FLASH_LAUNCHES["12b_deepseek_mla"] = f32_flash_launches() - f0
        undo = replay_routes(torch, routes_k)
        try:
            plain, _ = model(tokens, force_kernel=False)
        finally:
            undo()
        cmp_f32 = logits_rel(torch, logits, plain)
    del logits, plain, routes_k, model
    free()
    assert F32_FLASH_LAUNCHES["12b_deepseek_mla"] == cfg.n_layers
    fwd = float(np.median(forward_s))
    row = {"phase": "deepseek_main_path", "check": "b_forward",
           "arch": cfg.name, "tokens": [1, MODEL_TOKENS], "params": n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
           "head_dims": [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim],
           "experts": [cfg.n_experts, cfg.top_k, cfg.n_shared_experts],
           "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
           "compute_dtype": cfg.compute_dtype, "build_s": build_s,
           "forward_s": forward_s, "tokens_per_s": MODEL_TOKENS / fwd,
           "launches_per_forward": want_launch,
           "capacity": capacity(cfg, MODEL_TOKENS),
           "choices_dropped_by_layer": drops[0],
           "choices_dropped_same_every_run": drops[0] == drops[1] == drops[2],
           "choices_per_layer": MODEL_TOKENS * cfg.top_k,
           "lb_loss": lb, "z_loss": z, "breakdown": breakdown,
           "b_kernel_vs_plain_same_experts": cmp_b,
           "b_tol": LOGIT_TOL["bfloat16"],
           "b_kernel_vs_plain_own_routing": own,
           "b_layer_output_drift_same_experts": drift,
           "b_attention_in_situ_rel": in_situ,
           "b_float32_kernel_vs_plain_same_experts": cmp_f32,
           "peak_memory_gb": {"forward": forward_peak_gb,
                              "with_plain_forward": plain_peak_gb}}
    emit(row)
    assert len(drops[0]) == cfg.n_layers - cfg.first_dense_layers, row
    assert row["choices_dropped_same_every_run"], row
    assert max(in_situ) <= TOL["bfloat16"], row
    assert cmp_f32["rel_all"] <= LOGIT_TOL["float32"], row

    # ---- (c) 2 layers in float32 compute: forward against 16 decode steps
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32",
                               capacity_factor=2.0 * cfg.n_experts
                               / cfg.top_k)
    model2 = build_model(cfg2, seed=0)
    with torch.inference_mode():
        dropped = []
        model2(tokens[:, :16], moe_drops=dropped)
        err_c, excess_c = forward_vs_decode(torch, model2, tokens)
    del model2
    free()
    row = {"phase": "deepseek_main_path", "check": "c_forward_vs_decode",
           "layers": 2, "compute_dtype": "float32",
           "capacity_factor": cfg2.capacity_factor,
           "choices_dropped": [int(n) for n in dropped],
           "max_abs_diff": err_c, "excess_over_atol_rtol_0.05": excess_c}
    emit(row)
    assert row["choices_dropped"] == [0], row
    assert excess_c <= 0.0, row

    # ---- (d) serving at full width and depth, coded_layers="all"
    spec = ClusterSpec.serve_deadline(coded_layers="all")
    assert (spec.code.scheme, spec.code.n_workers, spec.code.k_blocks,
            spec.serve.coded_layers) == ("spacdc", 8, 4, "all")
    ratios = []
    torch.cuda.reset_peak_memory_stats()
    with Session(spec, device=dev) as s:
        undo = hold_ops_combines(torch, ratios)
        try:
            t0 = time.perf_counter()
            rep, launched = counted(kernels, total, lambda: s.serve(
                arch=DEEPSEEK_ARCH, tiny=False, seed=0,
                check_agreement=False, **DEEPSEEK_SERVE))
            serve_s = time.perf_counter() - t0
        finally:
            undo()
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = s._serve_models[(DEEPSEEK_ARCH, False, 0)]
        bat = next(iter(s._serve_batchers.values()))
        code = bat.code
        sites = code.n_instances
        steps = len(rep.step_stats)
        want = {"coded_matmul": 0, "berrut_combine": sites * (1 + steps),
                "mask_add": 0, "flash_attention": 0}
        row = {"phase": "deepseek_main_path", "check": "d_serve_all",
               "layers": cfg.n_layers, "sites_per_step": sites,
               "workload": DEEPSEEK_SERVE, **serve_summary(rep),
               "serve_call_s": serve_s, "launches": launched,
               "expected_launches": want, "held_calls": len(ratios),
               "max_bound_ratio": max(ratios),
               "shards_gb": sum(c.numel() for layer in code.layer_shards
                                for c in layer.values()) * 4 / 1e9
               + code.unembed_shards.numel() * 4 / 1e9,
               "peak_memory_gb": serve_peak_gb}
        emit(row)
        assert sites == 4 + 2 * (cfg.n_layers - 1) + 1, row
        assert launched == want, row
        assert all(st.dispatches == sites for st in rep.step_stats), row
        assert len(ratios) == want["berrut_combine"], row
        assert max(ratios) <= 1.0, row
        assert rep.tokens.shape == (DEEPSEEK_SERVE["batch"],
                                    DEEPSEEK_SERVE["gen"]), row
        assert (rep.tokens >= 0).all() and \
            (rep.tokens < cfg.vocab_size).all(), row

        # the encrypted step against the plain coded step, on the served
        # code, two stragglers masked out, every mask_add call held
        enc = RoundEngine(dataclasses.replace(
            spec, crypto=CryptoSpec(encrypt="real")), device=dev)
        plain_step = build_coded_step(model, s.engine.scheme, code)
        wired_step = build_coded_step(model, enc.scheme, code,
                                      wire_params=enc.serve_wire_params())
        mask = torch.ones(8)
        mask[[1, 5]] = 0.0
        b_enc, t_enc = 4, 4
        toks = torch.randint(1, cfg.vocab_size, (b_enc, t_enc),
                             generator=gen, device=dev)
        offsets = torch.arange(b_enc, dtype=torch.int32, device=dev) % 3
        held = []

        def wired_vs_plain():
            cw, cp = model.init_cache(b_enc, 16), model.init_cache(b_enc, 16)
            equal = []
            for t in range(t_enc):
                tok, pos = toks[:, t:t + 1], offsets + t
                lw, cw = wired_step.logits(cw, tok, pos, mask,
                                           code.step_materials(enc))
                lp, cp = plain_step.logits(cp, tok, pos, mask)
                equal.append(bool(torch.equal(lw, lp)))
            return equal
        undo = hold_ops_mask_adds(torch, held)
        try:
            equal, launched = counted(kernels, total, wired_vs_plain)
        finally:
            undo()
        enc.close()
        want = {"coded_matmul": 0, "berrut_combine": 2 * sites * t_enc,
                "mask_add": 4 * sites * t_enc, "flash_attention": 0}
        row = {"phase": "deepseek_main_path", "check": "d_encrypted_step",
               "slots": b_enc, "steps": t_enc, "stragglers_masked": [1, 5],
               "logits_bit_identical_by_step": equal, "launches": launched,
               "expected_launches": want, "mask_add_held_calls": len(held),
               "mask_add_held_equal": sum(ok for *_, ok in held)}
        emit(row)
        assert all(equal), row
        assert launched == want, row
        assert len(held) == want["mask_add"], row
        assert all(ok for *_, ok in held), row
        s._serve_batchers.clear()
        del bat, code, plain_step, wired_step, enc
        free()

        # the exact spec (mds, all 8 waited for): teacher-forced coded
        # logits against the plain decode step's, bfloat16 as served
        # (measured: through 27 random-weight layers the two roundings
        # drift apart as (b)'s do), then float32 (held, phase 9's rule)
        toks = torch.randint(1, cfg.vocab_size, (8, DEEPSEEK_TF_STEPS),
                             generator=gen, device=dev)
        tf_bf16 = exact_teacher_forced(torch, model, toks, TOL["bfloat16"])
        row = {"phase": "deepseek_main_path",
               "check": "d_exact_teacher_forced_bf16", "scheme": "mds",
               "coded_layers": "all", **tf_bf16}
        emit(row)
        del model
    del s
    free()
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        seed=0)
    tf = exact_teacher_forced(torch, model, toks, LOGIT_TOL["float32"])
    del model
    free()
    row = {"phase": "deepseek_main_path",
           "check": "d_exact_teacher_forced_f32", "scheme": "mds",
           "coded_layers": "all", "compute_dtype": "float32", **tf}
    emit(row)
    assert tf["max_rel_diff"] <= LOGIT_TOL["float32"], row
    assert tf["flips_outside_near_ties"] == 0, row
    emit({"phase": "deepseek_main_path", "check": "phase_total",
          "launches": total, "phase_s": time.perf_counter() - phase_t0})
    assert total["flash_attention"] == 3 * cfg.n_layers, total
    assert total["berrut_combine"] > 0 and total["mask_add"] > 0, total
    return total, flash_row


# --------------------------------------------------------------------------
# phase 13: the SSM mixers, rwkv6-1.6b and the jamba hybrid
# --------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
JAMBA_ARCH = "jamba-v0.1-52b"
# jamba at full width over one period of its layer pattern: 8 of its 32
# layers (7 mamba and the attention at layer 4, 4 dense and 4 MoE FFNs;
# 13.27 B float32 parameters, 53.1 GB); the whole model's 51.45 B (206
# GB in float32, 103 GB in bf16) does not fit the card
JAMBA_LAYERS = 8
# jamba's prefill attention: B, S, H, KV, hd (q . k), hd_v (GQA 32/8, no
# RoPE), causal
JAMBA_FLASH = (1, 4096, 32, 8, 128, 128)
# the room phase 13 asks of the card: jamba's serving peak, 69.45 GB on
# the H100 (53.2 GB of parameters, 8.1 GB of shards, the held unembed
# encode), and a margin
SSM_ROOM_GB = 74.0
SSM_SLOTS = 4
SSM_REQUESTS = 5                 # the fifth takes a slot freed by eviction
SSM_PROMPT, SSM_GEN = 6, 6
SSM_FVD_STEPS = 16
SSM_TF_STEPS = 8
SSM_CLASSES = (("flash_attention", ("flash_fwd",)),
               ("conv", ("conv", "fprop")),
               ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet")),
               ("moe_dispatch_combine", ("index", "gather", "scatter",
                                         "cumsum", "scan", "topk", "sort",
                                         "radix")),
               ("casts", ("copy_kernel",)))


def annotate_scans(torch):
    """Make every ``chunked_scan`` call of the SSM mixers launch a marker
    kernel (``SCAN_MARKER``, a zero-cycle ``torch.cuda._sleep``) just
    before and just after it, so that a device trace of one stream shows
    where each scan's kernels start and end.  Returns the function that
    undoes it and the host's count of scan calls so far."""
    from repro_torch.models import ssm
    run = ssm.chunked_scan
    calls = [0]

    def chunked_scan(*args):
        calls[0] += 1
        torch.cuda._sleep(0)
        try:
            return run(*args)
        finally:
            torch.cuda._sleep(0)
    ssm.chunked_scan = chunked_scan

    def undo():
        ssm.chunked_scan = run
    return undo, lambda: calls[0]


def timed_forwards(torch, model, tokens, kernels: dict, total: dict,
                   want_launch: dict) -> dict:
    """Two counted forwards on ``tokens`` between device syncs (each
    launching ``want_launch``), then one more profiled by
    ``profile_device`` with the scans annotated: wall seconds, each MoE
    layer's dropped choices per run, the profile, and the peak memory of
    the counted runs."""
    import numpy as np
    torch.cuda.reset_peak_memory_stats()
    forward_s, drops = [], []
    with torch.inference_mode():
        for r in range(2):
            layer_drops = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            (logits, _), got = counted(kernels, total, lambda: model(
                tokens, moe_drops=layer_drops))
            torch.cuda.synchronize()
            forward_s.append(time.perf_counter() - t)
            assert got == want_launch, (r, got)
            drops.append([int(n) for n in layer_drops])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert tuple(logits.shape) == (*tokens.shape, model.cfg.vocab_size)
        assert logits.dtype == getattr(torch, model.cfg.compute_dtype)
        assert bool(torch.isfinite(logits).all())
        del logits
        undo, scans = annotate_scans(torch)
        try:
            split = profile_device(torch, lambda: model(tokens), SSM_CLASSES,
                                   scans=scans)
        finally:
            undo()
    fwd = float(np.median(forward_s))
    return {"forward_s": forward_s, "tokens_per_s": tokens.numel() / fwd,
            "choices_dropped_by_layer": drops[0],
            "choices_dropped_same_every_run": all(d == drops[0]
                                                  for d in drops),
            "launches_per_forward": want_launch, "breakdown": split,
            "scan_share_of_busy": split["device_ms_by_class"]["scan"]
            / split["device_busy_ms"],
            "peak_memory_gb": peak_gb}


def jittered_rel(torch, model, tokens, full, **kw) -> float:
    """The model's own float32 noise on ``tokens``: max |forward - full|
    over max |full|, the forward run with the embedding table scaled by
    (1 + 2^-23 N), N a seeded standard normal draw (its inputs moved by
    float32 rounding), the table restored after."""
    table = model.embedding["table"]
    saved = table.detach().clone()
    g = torch.Generator(device=table.device)
    g.manual_seed(99)
    with torch.no_grad():
        table.mul_(1 + 2.0 ** -23 * torch.randn(
            table.shape, generator=g, device=table.device))
        try:
            with torch.inference_mode():
                jit, _ = model(tokens, **kw)
        finally:
            table.copy_(saved)
    return float((jit.float() - full.float()).abs().max()
                 / full.float().abs().max())


def forward_vs_decode_rel(torch, model, tokens, n: int,
                          mrope=None) -> dict:
    """The forward's logits on the first n tokens against n teacher-forced
    ``decode_step`` calls, over max |forward|, and the float32 rule that
    holds them: 1e-4, or twice the model's own float32 noise
    (``jittered_rel``) where that is larger, for a model whose logits
    move more than that under float32 rounding of its inputs.  An RWKV6
    head's output is ``r . (u k) v^T`` at the first token and then that
    sum over a decayed state, and its group norm rescales the head to
    unit variance: where the sum nearly cancels, rounding of r and k is
    rescaled with it."""
    with torch.inference_mode():
        full, inc = forward_and_decode(torch, model, tokens, n, mrope)
    rel = float((inc - full).abs().max() / full.abs().max())
    noise = jittered_rel(torch, model, tokens[:, :n], full,
                         mrope_positions=None if mrope is None
                         else mrope[:, :, :n])
    return {"steps": n, "rel": rel, "own_float32_noise": noise,
            "tol": max(LOGIT_TOL["float32"], 2 * noise),
            "argmax_agreement": float((inc.argmax(-1) == full.argmax(-1))
                                      .float().mean())}


def slot_requests(cfg):
    """``SSM_REQUESTS`` requests at t = 0 of ``SSM_PROMPT`` prompt tokens
    and ``SSM_GEN`` to generate, prompts from a seeded generator: over
    ``SSM_SLOTS`` slots the first four finish together and the fifth is
    admitted into slot 0, which request 0's state fills."""
    import numpy as np
    from repro_torch.runtime.serve_loop import Request
    rng = np.random.default_rng(13)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, SSM_PROMPT)
                    .astype(np.int32), gen=SSM_GEN)
            for i in range(SSM_REQUESTS)]


def model_serving(torch, dev, cfg, gen, kernels: dict, total: dict,
                  label: str, hold_bf16: bool,
                  phase: str = "ssm_main_path") -> None:
    """Phase 13 (b) and (d), phase 14 (c): ``cfg`` served under
    ``serve_deadline(coded_layers="all")`` over ``SSM_SLOTS`` slots
    (counted: one ``berrut_combine`` per site at the encode and per step,
    every call held); on the served code, the ``encrypt="real"`` step
    bit-identical to the plain coded step with every ``mask_add`` call
    held; the exact spec's
    teacher-forced coded logits against the plain step's (MoE choices
    replayed), bfloat16 as served (held at 2e-2 when ``hold_bf16``, else
    reported) and in float32 compute (held at 1e-4); the fifth request
    admitted into a freed slot served as it is alone (exact spec; the
    tokens with the admission reset skipped are reported)."""
    import gc

    import numpy as np
    from repro_torch.api import ClusterSpec, CryptoSpec, ServeSpec, Session
    from repro_torch.models import build_model
    from repro_torch.models.coded import build_coded_step
    from repro_torch.runtime.engine import RoundEngine
    from repro_torch.runtime.serve_loop import ContinuousBatcher

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    serve = ServeSpec(coded_layers="all", max_slots=SSM_SLOTS)
    spec = dataclasses.replace(ClusterSpec.serve_deadline(coded_layers="all"),
                               serve=serve)
    reqs = slot_requests(cfg)
    ratios = []
    free()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with Session(spec, device=dev) as s:
        undo = hold_ops_combines(torch, ratios)
        try:
            t0 = time.perf_counter()
            rep, launched = counted(kernels, total, lambda: s.serve(
                arch=cfg, requests=reqs, check_agreement=False))
            serve_s = time.perf_counter() - t0
        finally:
            undo()
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        model = s._serve_models[(cfg, True, 0)]
        code = next(iter(s._serve_batchers.values())).code
        sites, steps = code.n_instances, len(rep.step_stats)
        want = {"coded_matmul": 0, "berrut_combine": sites * (1 + steps),
                "mask_add": 0, "flash_attention": 0}
        fifth = next(r for r in rep.requests if r.rid == SSM_REQUESTS - 1)
        row = {"phase": phase, "check": f"{label}_serve_all",
               "arch": cfg.name, "layers": cfg.n_layers,
               "sites_per_step": sites, "slots": SSM_SLOTS,
               "requests": [SSM_REQUESTS, SSM_PROMPT, SSM_GEN],
               **serve_summary(rep), "serve_call_s": serve_s,
               "fifth_admitted_s": fifth.admitted_s, "launches": launched,
               "expected_launches": want, "held_calls": len(ratios),
               "max_bound_ratio": max(ratios),
               "shards_gb": (sum(c.numel() for layer in code.layer_shards
                                 for c in layer.values())
                             + code.unembed_shards.numel()) * 4 / 1e9,
               "peak_memory_gb": serve_peak_gb,
               "allocated_before_serve_gb": before_gb}
        emit(row)
        assert launched == want, row
        assert all(st.dispatches == sites for st in rep.step_stats), row
        assert len(ratios) == want["berrut_combine"], row
        assert max(ratios) <= 1.0, row
        assert fifth.admitted_s > 0, row
        assert all(len(r.tokens) == SSM_GEN for r in rep.requests), row
        assert all(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
                   for r in rep.requests), row

        # the encrypted step against the plain coded step, on the served
        # code, two stragglers masked out, every mask_add call held
        enc = RoundEngine(dataclasses.replace(
            spec, crypto=CryptoSpec(encrypt="real")), device=dev)
        plain_step = build_coded_step(model, s.engine.scheme, code)
        wired_step = build_coded_step(model, enc.scheme, code,
                                      wire_params=enc.serve_wire_params())
        mask = torch.ones(8)
        mask[[1, 5]] = 0.0
        b_enc, t_enc = 4, 4
        toks = torch.randint(1, cfg.vocab_size, (b_enc, t_enc),
                             generator=gen, device=dev)
        offsets = torch.arange(b_enc, dtype=torch.int32, device=dev) % 3
        held = []

        def wired_vs_plain():
            cw, cp = model.init_cache(b_enc, 16), model.init_cache(b_enc, 16)
            equal = []
            for t in range(t_enc):
                tok, pos = toks[:, t:t + 1], offsets + t
                lw, cw = wired_step.logits(cw, tok, pos, mask,
                                           code.step_materials(enc))
                lp, cp = plain_step.logits(cp, tok, pos, mask)
                equal.append(bool(torch.equal(lw, lp)))
            return equal
        undo = hold_ops_mask_adds(torch, held)
        try:
            equal, launched = counted(kernels, total, wired_vs_plain)
        finally:
            undo()
        enc.close()
        want = {"coded_matmul": 0, "berrut_combine": 2 * sites * t_enc,
                "mask_add": 4 * sites * t_enc, "flash_attention": 0}
        row = {"phase": phase, "check": f"{label}_encrypted_step",
               "slots": b_enc, "steps": t_enc, "stragglers_masked": [1, 5],
               "logits_bit_identical_by_step": equal, "launches": launched,
               "expected_launches": want, "mask_add_held_calls": len(held),
               "mask_add_held_equal": sum(ok for *_, ok in held)}
        emit(row)
        assert all(equal), row
        assert launched == want, row
        assert len(held) == want["mask_add"], row
        assert all(ok for *_, ok in held), row
        s._serve_batchers.clear()
        del plain_step, wired_step, enc, code
        free()              # the served shards' cached blocks back too

        # the exact spec (mds, all 8 waited for): teacher-forced coded
        # logits against the plain decode step's, bfloat16 as served
        tf_toks = torch.randint(1, cfg.vocab_size, (8, SSM_TF_STEPS),
                                generator=gen, device=dev)
        tf_bf16 = exact_teacher_forced(torch, model, tf_toks,
                                       TOL["bfloat16"])
        row = {"phase": phase, "check": f"{label}_teacher_forced_bf16",
               "scheme": "mds", "coded_layers": "all",
               "held": hold_bf16, **tf_bf16}
        emit(row)
        if hold_bf16:
            assert tf_bf16["max_rel_diff"] <= TOL["bfloat16"], row
            assert tf_bf16["flips_outside_near_ties"] == 0, row
        del model
    del s
    free()

    # the fifth request, admitted into the slot that request 0's state
    # filled, against the same request served alone (exact spec, 4 slots)
    spec_x = dataclasses.replace(exact_spec("all"), serve=serve)
    with Session(spec_x, device=dev) as s:
        tokens = {}
        for name, batch in (("shared", reqs), ("alone", reqs[-1:])):
            rep, _ = counted(kernels, total, lambda: s.serve(
                arch=cfg, requests=batch, check_agreement=False))
            tokens[name] = next(r.tokens for r in rep.requests
                                if r.rid == SSM_REQUESTS - 1)
        reset = ContinuousBatcher.__dict__["_zero_slot"]
        ContinuousBatcher._zero_slot = staticmethod(lambda cache, i: cache)
        try:
            rep, _ = counted(kernels, total, lambda: s.serve(
                arch=cfg, requests=reqs, check_agreement=False))
        finally:
            ContinuousBatcher._zero_slot = reset
        tokens["no_reset"] = next(r.tokens for r in rep.requests
                                  if r.rid == SSM_REQUESTS - 1)
    del s
    free()
    row = {"phase": phase, "check": f"{label}_reused_slot",
           "tokens": {k: v.tolist() for k, v in tokens.items()},
           "equal_to_alone": bool(np.array_equal(tokens["shared"],
                                                 tokens["alone"])),
           "no_reset_equal_to_alone": bool(np.array_equal(
               tokens["no_reset"], tokens["alone"]))}
    emit(row)
    assert row["equal_to_alone"], row

    # the exact spec's teacher-forced step in float32 compute (held)
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        seed=0)
    tf = exact_teacher_forced(torch, model, tf_toks, LOGIT_TOL["float32"])
    del model
    free()
    row = {"phase": phase, "check": f"{label}_teacher_forced_f32",
           "scheme": "mds", "coded_layers": "all",
           "compute_dtype": "float32", **tf}
    emit(row)
    assert tf["max_rel_diff"] <= LOGIT_TOL["float32"], row
    assert tf["flips_outside_near_ties"] == 0, row


def attention_in_situ(torch, model, layers_in_out: list,
                      mrope=None) -> dict:
    """{layer: max |kernel - plain| over max |plain|} of every GQA
    attention layer's mixer, fed that layer's input from a recorded
    forward (``capture_layers``), through the flash kernel and through
    the plain version; ``mrope`` the forward's M-RoPE streams."""
    from repro_torch.models.attention import attn_forward
    from repro_torch.models.layers import apply_norm
    cfg = model.cfg
    s = layers_in_out[0][0].shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=layers_in_out[0][0].device)[None]
    out = {}
    with torch.inference_mode():
        for i, (layer, (x_in, _)) in enumerate(zip(model.layers,
                                                   layers_in_out)):
            if layer.desc.mixer != "attn":
                continue
            h = apply_norm(layer.norm1, x_in, cfg)
            y_k = attn_forward(layer.mixer, h, cfg, positions,
                               use_rope=layer.desc.rope,
                               mrope_positions=mrope)
            y_p = attn_forward(layer.mixer, h, cfg, positions,
                               use_rope=layer.desc.rope,
                               mrope_positions=mrope, force_kernel=False)
            out[i] = rel_diff(torch, y_k, y_p)[1]
    return out


def ssm_main_path(torch, dev) -> tuple:
    """Phase 13: the SSM mixers on the card, both models' weights float32
    from seed 0, compute bf16.  (a) rwkv6-1.6b at full width and depth (24
    layers): the forward on 1 x 4096 tokens, counted (no kernel: the WKV
    scan is plain PyTorch) and timed twice, a profiled forward's device
    split (the scans' launches told apart by ``annotate_scans``), idle
    share and launches, peak memory; the forward against 16 decode steps
    in float32 compute (held, ``forward_vs_decode_rel``) and bf16 (reported).
    (b) its coded serving (``model_serving``: the unembed its one site).
    (c) jamba-v0.1-52b at full width over one period of its pattern (8 of
    32 layers): the flash kernel at its attention's shape against its
    plain version (``check_model_flash``); the bf16 forward on 1 x 4096
    tokens as (a) (one flash launch, dropped MoE choices per layer); the
    attention layer through the kernel against the plain version on that
    layer's own input (2e-2); the float32-compute forward, kernel against
    plain with the expert choices replayed (1e-4); the float32 forward
    against 16 decode steps with ``capacity_factor`` raised so that
    nothing drops (held as (a)).  (d) its coded serving (11 sites:
    attention's qkv and o, the dense FFNs' up and down, the unembed).
    Returns (the counted launches, the jamba flash row).  Phase 13 alone:
    ``build_kernels(torch)`` then ``ssm_main_path(torch,
    torch.device("cuda"))``."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase = "ssm_main_path"
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    rwkv = get_config(RWKV_ARCH)
    jamba = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    free_b, total_b = torch.cuda.mem_get_info()
    room = {"phase": phase, "check": "room", "free_gb": free_b / 1e9,
            "card_gb": total_b / 1e9,
            "allocated_here_gb": torch.cuda.memory_allocated() / 1e9,
            "param_count": {RWKV_ARCH: rwkv.param_count(),
                            f"{JAMBA_ARCH}[:{JAMBA_LAYERS}]":
                                jamba.param_count()},
            "asked_gb": SSM_ROOM_GB}
    emit(room)
    assert free_b / 1e9 >= SSM_ROOM_GB, \
        f"phase 13 needs {SSM_ROOM_GB} GB free on the card: {room}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    tokens = torch.randint(0, rwkv.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device=dev)
    no_launch = dict.fromkeys(kernels, 0)

    # ---- (a) rwkv6-1.6b: the forward, counted from zero
    t0 = time.perf_counter()
    model = build_model(rwkv, seed=0)                    # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fwd = timed_forwards(torch, model, tokens, kernels, total, no_launch)
    n_params = sum(p.numel() for p in model.parameters())
    fvd_bf16 = forward_vs_decode_rel(torch, model, tokens, SSM_FVD_STEPS)
    del model
    free()
    model = build_model(dataclasses.replace(rwkv, compute_dtype="float32"),
                        seed=0)
    fvd = forward_vs_decode_rel(torch, model, tokens, SSM_FVD_STEPS)
    del model
    free()
    row = {"phase": phase, "check": "a_rwkv_forward", "arch": rwkv.name,
           "tokens": [1, MODEL_TOKENS], "params": n_params,
           "layers": rwkv.n_layers, "d_model": rwkv.d_model,
           "heads": [rwkv.d_model // rwkv.rwkv_head_dim, rwkv.rwkv_head_dim],
           "d_ff": rwkv.d_ff, "vocab": rwkv.vocab_size,
           "compute_dtype": rwkv.compute_dtype, "build_s": build_s, **fwd,
           "a_forward_vs_decode_f32": fvd,
           "a_forward_vs_decode_bf16": fvd_bf16}
    emit(row)
    assert fwd["breakdown"]["scan_calls"] == rwkv.n_layers, row
    assert fvd["rel"] <= fvd["tol"], row

    # ---- (b) rwkv6-1.6b: coded serving, the unembed its one site
    model_serving(torch, dev, rwkv, gen, kernels, total, "b_rwkv",
                  hold_bf16=True)

    # ---- (c) jamba: flash at its attention's shape, then the forward
    flash_row = check_model_flash(torch, gen, dev, JAMBA_FLASH, phase,
                                  "c_jamba_flash")
    free()
    t0 = time.perf_counter()
    model = build_model(jamba, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_attn = sum(layer.desc.mixer == "attn" for layer in model.layers)
    fwd = timed_forwards(torch, model, tokens, kernels, total,
                         dict(no_launch, flash_attention=n_attn))
    n_params = sum(p.numel() for p in model.parameters())
    # held: the attention layer through the kernel against the plain
    # version on the kernel forward's own input to that layer
    layers_k, undo_hooks = capture_layers(model)
    try:
        with torch.inference_mode():
            model(tokens)
    finally:
        undo_hooks()
    in_situ = attention_in_situ(torch, model, layers_k)
    del layers_k, model
    free()
    # the same weights in float32 compute: kernel forward against the
    # plain attention replaying its experts (held)
    model = build_model(dataclasses.replace(jamba, compute_dtype="float32"),
                        seed=0)
    with torch.inference_mode():
        routes_k, undo = record_routes()
        f0 = f32_flash_launches()
        try:
            logits, _ = model(tokens)
        finally:
            undo()
        F32_FLASH_LAUNCHES["13c_jamba"] = f32_flash_launches() - f0
        undo = replay_routes(torch, routes_k)
        try:
            plain, _ = model(tokens, force_kernel=False)
        finally:
            undo()
        cmp_f32 = logits_rel(torch, logits, plain)
    del logits, plain, routes_k, model
    free()
    # float32, nothing dropped: the forward against 16 decode steps
    cfg_c = dataclasses.replace(jamba, compute_dtype="float32",
                                capacity_factor=2.0 * jamba.n_experts
                                / jamba.top_k)
    model = build_model(cfg_c, seed=0)
    with torch.inference_mode():
        dropped = []
        model(tokens[:, :SSM_FVD_STEPS], moe_drops=dropped)
    fvd = forward_vs_decode_rel(torch, model, tokens, SSM_FVD_STEPS)
    del model
    free()
    row = {"phase": phase, "check": "c_jamba_forward", "arch": jamba.name,
           "layers": [jamba.n_layers, get_config(JAMBA_ARCH).n_layers],
           "tokens": [1, MODEL_TOKENS], "params": n_params,
           "d_model": jamba.d_model, "heads": [jamba.n_heads,
                                               jamba.n_kv_heads],
           "mamba": {"d_state": jamba.d_state, "conv": jamba.conv_width,
                     "expand": jamba.expand},
           "experts": [jamba.n_experts, jamba.top_k],
           "capacity": capacity(jamba, MODEL_TOKENS),
           "choices_per_layer": MODEL_TOKENS * jamba.top_k,
           "compute_dtype": jamba.compute_dtype, "build_s": build_s, **fwd,
           "c_attention_in_situ_rel": in_situ, "c_tol": TOL["bfloat16"],
           "c_float32_kernel_vs_plain_same_experts": cmp_f32,
           "c_forward_vs_decode_f32": dict(
               fvd, capacity_factor=cfg_c.capacity_factor,
               choices_dropped=[int(n) for n in dropped])}
    emit(row)
    assert n_attn == 1 and fwd["breakdown"]["scan_calls"] == 7, row
    assert len(fwd["choices_dropped_by_layer"]) == 4, row
    assert fwd["choices_dropped_same_every_run"], row
    assert max(in_situ.values()) <= TOL["bfloat16"], row
    assert cmp_f32["rel_all"] <= LOGIT_TOL["float32"], row
    assert row["c_forward_vs_decode_f32"]["choices_dropped"] == [0] * 4, row
    assert fvd["rel"] <= fvd["tol"], row

    # ---- (d) jamba: coded serving, 11 sites
    model_serving(torch, dev, jamba, gen, kernels, total, "d_jamba",
                  hold_bf16=False)
    emit({"phase": phase, "check": "phase_total", "launches": total,
          "phase_s": time.perf_counter() - phase_t0})
    assert total["flash_attention"] == 2 * n_attn, total
    assert total["berrut_combine"] > 0 and total["mask_add"] > 0, total
    return total, flash_row


# --------------------------------------------------------------------------
# phase 14: M-RoPE (qwen2-vl-72b) and the encoder-decoder (whisper-small)
# --------------------------------------------------------------------------

def vl_positions(b: int, s: int, text_before, grid: tuple):
    """(3, b, s) int32 numpy M-RoPE streams (temporal, height, width) of a
    synthetic vision-language prompt laid out as in Qwen2-VL (arXiv:
    2409.12191): row i has ``text_before[i]`` text tokens at t = h = w =
    position, then one image of ``grid`` = (rows, cols) patches at (t0,
    t0 + row, t0 + col) with t0 the next position, then text again from
    the largest position so far plus one, to length s."""
    import numpy as np
    rows, cols = grid
    out = np.zeros((3, b, s), np.int32)
    for i in range(b):
        n = int(text_before[i])
        pos = [(p, p, p) for p in range(n)]
        pos += [(n, n + r, n + c) for r in range(rows) for c in range(cols)]
        nxt = n + max(rows, cols)
        while len(pos) < s:
            pos.append((nxt, nxt, nxt))
            nxt += 1
        out[:, i] = np.asarray(pos[:s], np.int32).T
    return out


VL_ARCH = "qwen2-vl-72b"
WHISPER_ARCH = "whisper-small"
# qwen2-vl-72b at full width (d 8192, 64 heads over 8 KV heads of 128,
# d_ff 29568, vocab 152064, qkv bias), cut in depth: its 80 layers hold
# 72.7 B parameters, 291 GB in float32.  The forward keeps 8 (9.5 B, 38
# GB); serving keeps 4 (6.0 B, 24 GB), with 38 GB of shards at N/K = 2,
# and 8 would need ~104 GB
VL_FORWARD_LAYERS = 8
VL_SERVE_LAYERS = 4
# the forward's synthetic vision-language prompt (``vl_positions``): 1024
# text tokens, one image of 32 x 32 patches, then text to MODEL_TOKENS
VL_TEXT_BEFORE = 1024
VL_GRID = (32, 32)
# the decode check's prompt: 4 text tokens, 3 x 3 patches, 3 text tokens
VL_FVD = (4, (3, 3))
FVD_STEPS = 16
# the room phase 14 asks of the card: qwen2-vl's serving peak, 77.13 GB on
# the H100 (the parameters, the layers' shards and the unembed's encode:
# its blocks, their stack with the noise block and its 10 GB of shards),
# and a margin
VL_ROOM_GB = 78.0
# whisper-small at full width and depth on a 4096-frame prefill: the
# decoder takes 4096 // dec_len_ratio = 1024 tokens (``input_specs``)
WHISPER_FRAMES = 4096
# the flash kernel at phase 14's shapes: (check, (B, Sq, H, KV, hd, hd_v),
# Skv, causal), as the models call it
PHASE14_FLASH = (
    ("a_whisper_encoder", (1, 4096, 12, 12, 64, 64), 4096, False),
    ("a_whisper_decoder_self", (1, 1024, 12, 12, 64, 64), 1024, True),
    ("a_whisper_cross", (1, 1024, 12, 12, 64, 64), 4096, False),
    ("a_qwen2_vl", (1, 4096, 64, 8, 128, 128), 4096, True))


def hold_flash_calls(torch, rows: list):
    """Make every ``ops.flash_attention`` call in the process also run the
    plain version on the same q, k and v and append ``{causal, Sq, Skv,
    rel}`` (max |kernel - plain| over max |plain|) to ``rows``.  The
    plain version launches no kernel.  Returns the function that undoes
    it."""
    from repro_torch.kernels import ops, ref
    run = ops.flash_attention

    def flash_attention(q, k, v, *, causal=True, softcap=0.0,
                        force_kernel=None):
        got = run(q, k, v, causal=causal, softcap=softcap,
                  force_kernel=force_kernel)
        want = ref.mha_reference(q, k, v, causal=causal, softcap=softcap)
        rows.append({"causal": causal, "Sq": q.shape[1], "Skv": k.shape[1],
                     "rel": rel_diff(torch, got, want)[1]})
        return got
    ops.flash_attention = flash_attention

    def undo():
        ops.flash_attention = run
    return undo


def timed_counted(torch, kernels: dict, total: dict, fn, want: dict,
                  runs: int = 3) -> tuple:
    """``runs`` calls of ``fn`` between device syncs, each counted from
    zero and launching exactly ``want``: (the last result, wall seconds
    of each, the peak memory in GB)."""
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for r in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, got = counted(kernels, total, fn)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        assert got == want, (r, got, want)
    return out, walls, torch.cuda.max_memory_allocated() / 1e9


def mrope_encdec_main_path(torch, dev) -> tuple:
    """Phase 14: M-RoPE and the encoder-decoder on the card, weights
    float32 from seed 0, compute bf16.  (a) the flash kernel at whisper's
    head width 64 (the encoder's full 4096 x 4096, the decoder's causal
    1024 x 1024, cross-attention's full 1024 x 4096) and at qwen2-vl's GQA
    64/8 (causal 4096), each against its plain version
    (``check_model_flash``).  (b) qwen2-vl-72b at full width over 8 of its
    80 layers on 1 x 4096 tokens with the M-RoPE streams of a synthetic
    vision-language prompt (``vl_positions``: text, a 32 x 32 patch grid,
    text): the forward counted (8 flash launches) and timed, a profiled
    forward's device split and idle share, the peak memory; measured: the
    bf16 logits against the kernels-off forward's, and against the same
    forward on plain RoPE (identical before the image, different after);
    held: every layer's attention through the kernel against the plain
    version on its own input (2e-2), the float32-compute forward against
    the kernels-off one (1e-4), and the float32 forward against 16 decode
    steps fed the same (3, 1, 1) streams (1e-4, or twice the model's own
    float32 noise where larger).  (c) its coded serving at full width over
    4 of 80 layers (``model_serving``: 17 sites, the encrypted step, the
    teacher-forced logits).  (d) whisper-small at full width and depth on
    4096 seeded bf16 frames and 1024 tokens: the forward counted (36 flash
    launches) and timed; held: every flash call of a bf16 forward against
    the plain version on its inputs (2e-2), the float32 forward against
    the kernels-off one (1e-4), and 16 decode steps from a cache whose
    cross rows (``CROSS_LEN`` = 4096) are each layer's ``project_kv`` of
    the encoder output, against the float32 forward (1e-4).  Returns (the
    counted launches, {check: the bfloat16 flash row of (a)}).  Phase 14
    alone: ``build_kernels(torch)`` then ``mrope_encdec_main_path(torch,
    torch.device("cuda"))``."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.models import build_model
    from repro_torch.models.attention import project_kv
    from repro_torch.models.encdec import CROSS_LEN
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel}
    total = {k: 0 for k in kernels}
    phase = "mrope_encdec_main_path"
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    vl = dataclasses.replace(get_config(VL_ARCH),
                             n_layers=VL_FORWARD_LAYERS)
    vl_serve = dataclasses.replace(vl, n_layers=VL_SERVE_LAYERS)
    whisper = get_config(WHISPER_ARCH)
    free_b, total_b = torch.cuda.mem_get_info()
    room = {"phase": phase, "check": "room", "free_gb": free_b / 1e9,
            "card_gb": total_b / 1e9,
            "allocated_here_gb": torch.cuda.memory_allocated() / 1e9,
            "param_count": {VL_ARCH: get_config(VL_ARCH).param_count(),
                            f"{VL_ARCH}[:{VL_FORWARD_LAYERS}]":
                                vl.param_count(),
                            f"{VL_ARCH}[:{VL_SERVE_LAYERS}]":
                                vl_serve.param_count(),
                            WHISPER_ARCH: whisper.param_count()},
            "asked_gb": VL_ROOM_GB}
    emit(room)
    assert free_b / 1e9 >= VL_ROOM_GB, \
        f"phase 14 needs {VL_ROOM_GB} GB free on the card: {room}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    no_launch = dict.fromkeys(kernels, 0)

    # ---- (a) the flash kernel at the new shapes
    flash_rows = {}
    for check, shape, skv, causal in PHASE14_FLASH:
        flash_rows[check] = check_model_flash(torch, gen, dev, shape, phase,
                                              check, skv=skv, causal=causal)
        free()

    # ---- (b) qwen2-vl-72b over 8 layers: the forward, counted from zero
    tokens = torch.randint(0, vl.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device=dev)
    mrope = torch.from_numpy(vl_positions(
        1, MODEL_TOKENS, [VL_TEXT_BEFORE], VL_GRID)).to(dev)
    t0 = time.perf_counter()
    model = build_model(vl, seed=0)                       # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    with torch.inference_mode():
        (logits, _), forward_s, peak_gb = timed_counted(
            torch, kernels, total,
            lambda: model(tokens, mrope_positions=mrope),
            dict(no_launch, flash_attention=vl.n_layers))
        assert tuple(logits.shape) == (1, MODEL_TOKENS, vl.vocab_size)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())
        breakdown = profile_device(
            torch, lambda: model(tokens, mrope_positions=mrope),
            FORWARD_CLASSES)
        plain, _ = model(tokens, mrope_positions=mrope, force_kernel=False)
        cmp_b = logits_rel(torch, logits, plain)
        del plain
        # M-RoPE against plain RoPE at arange: the same before the image
        # (three equal streams), not after it
        rope, _ = model(tokens)
        diff = (rope[0].float() - logits[0].float()).abs().amax(dim=-1)
        scale = float(logits.float().abs().max())
        vs_rope = {"max_abs_before_image": float(diff[:VL_TEXT_BEFORE].max()),
                   "rel_from_image_on": float(diff[VL_TEXT_BEFORE:].max())
                   / scale}
        del rope, diff
        layers_k, undo_hooks = capture_layers(model)
        try:
            model(tokens, mrope_positions=mrope)
        finally:
            undo_hooks()
        in_situ = attention_in_situ(torch, model, layers_k, mrope)
    del logits, layers_k, model
    free()
    model = build_model(dataclasses.replace(vl, compute_dtype="float32"),
                        seed=0)
    with torch.inference_mode():
        f0 = f32_flash_launches()
        logits, _ = model(tokens, mrope_positions=mrope)
        F32_FLASH_LAUNCHES["14b_qwen2_vl"] = f32_flash_launches() - f0
        plain, _ = model(tokens, mrope_positions=mrope, force_kernel=False)
        cmp_f32 = logits_rel(torch, logits, plain)
    del logits, plain
    fvd_mrope = torch.from_numpy(vl_positions(
        1, FVD_STEPS, [VL_FVD[0]], VL_FVD[1])).to(dev)
    fvd = forward_vs_decode_rel(torch, model, tokens, FVD_STEPS, fvd_mrope)
    del model
    free()
    row = {"phase": phase, "check": "b_qwen2_vl_forward", "arch": vl.name,
           "layers": [vl.n_layers, get_config(VL_ARCH).n_layers],
           "tokens": [1, MODEL_TOKENS], "params": n_params,
           "d_model": vl.d_model, "heads": [vl.n_heads, vl.n_kv_heads],
           "head_dim": vl.head_dim_, "d_ff": vl.d_ff,
           "vocab": vl.vocab_size, "mrope_sections": list(vl.mrope_sections),
           "prompt": {"text_before": VL_TEXT_BEFORE, "grid": list(VL_GRID),
                      "max_position": int(mrope.max())},
           "compute_dtype": vl.compute_dtype, "build_s": build_s,
           "forward_s": forward_s,
           "tokens_per_s": MODEL_TOKENS / float(np.median(forward_s)),
           "launches_per_forward": dict(no_launch,
                                        flash_attention=vl.n_layers),
           "breakdown": breakdown, "peak_memory_gb": peak_gb,
           "b_kernel_vs_plain_bf16": cmp_b,
           "b_mrope_vs_plain_rope_bf16": vs_rope,
           "b_attention_in_situ_rel": in_situ, "b_tol": TOL["bfloat16"],
           "b_float32_kernel_vs_plain": cmp_f32,
           "b_forward_vs_decode_f32": dict(
               fvd, streams=fvd_mrope[:, 0].tolist())}
    emit(row)
    assert len(in_situ) == vl.n_layers, row
    assert max(in_situ.values()) <= TOL["bfloat16"], row
    assert cmp_f32["rel_all"] <= LOGIT_TOL["float32"], row
    assert vs_rope["rel_from_image_on"] > 0.0, row
    assert fvd["rel"] <= fvd["tol"], row

    # ---- (c) qwen2-vl-72b over 4 layers: coded serving, 17 sites
    model_serving(torch, dev, vl_serve, gen, kernels, total, "c_qwen2_vl",
                  hold_bf16=True, phase=phase)
    free()

    # ---- (d) whisper-small at full width and depth
    frames = torch.randn((1, WHISPER_FRAMES, whisper.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    n_dec = max(WHISPER_FRAMES // whisper.dec_len_ratio, 16)
    wtoks = torch.randint(0, whisper.vocab_size, (1, n_dec), generator=gen,
                          device=dev)
    n_flash = whisper.n_encoder_layers + 2 * whisper.n_layers
    t0 = time.perf_counter()
    model = build_model(whisper, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    with torch.inference_mode():
        (logits, _), forward_s, peak_gb = timed_counted(
            torch, kernels, total, lambda: model(frames, wtoks),
            dict(no_launch, flash_attention=n_flash))
        assert tuple(logits.shape) == (1, n_dec, whisper.vocab_size)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())
        breakdown = profile_device(torch, lambda: model(frames, wtoks),
                                   FORWARD_CLASSES)
        plain, _ = model(frames, wtoks, force_kernel=False)
        cmp_b = logits_rel(torch, logits, plain)
        del plain
        calls = []
        undo = hold_flash_calls(torch, calls)
        try:
            model(frames, wtoks)
        finally:
            undo()
    del logits, model
    free()
    in_situ = {"encoder": [c["rel"] for c in calls[:whisper.n_encoder_layers]],
               "self": [c["rel"] for c in calls[whisper.n_encoder_layers::2]],
               "cross": [c["rel"] for c in
                         calls[whisper.n_encoder_layers + 1::2]]}
    shapes = sorted({(c["causal"], c["Sq"], c["Skv"]) for c in calls})
    model = build_model(dataclasses.replace(whisper, compute_dtype="float32"),
                        seed=0)
    with torch.inference_mode():
        f0 = f32_flash_launches()
        logits, _ = model(frames, wtoks)
        F32_FLASH_LAUNCHES["14d_whisper"] = f32_flash_launches() - f0
        plain, _ = model(frames, wtoks, force_kernel=False)
        cmp_f32 = logits_rel(torch, logits, plain)
        del logits, plain
        # 16 decode steps over the encoder output's 4096 cross rows
        full, _ = model(frames, wtoks[:, :FVD_STEPS])
        enc = model.encode(frames)
        cache = model.init_cache(1, FVD_STEPS)
        for layer, lc in zip(model.decoder, cache):
            k, v = project_kv(layer.cross_attn, enc, model.cfg)
            lc["cross"]["k"].copy_(k)
            lc["cross"]["v"].copy_(v)
        steps = []
        for t in range(FVD_STEPS):
            step, cache = model.decode_step(cache, wtoks[:, t:t + 1], t)
            steps.append(step[:, 0])
        inc = torch.stack(steps, dim=1).float()
        full = full.float()
        fvd = {"steps": FVD_STEPS, "cross_rows": CROSS_LEN,
               "rel": float((inc - full).abs().max() / full.abs().max()),
               "tol": LOGIT_TOL["float32"],
               "argmax_agreement": float((inc.argmax(-1) == full.argmax(-1))
                                         .float().mean())}
    del model, cache, enc, full, inc
    free()
    row = {"phase": phase, "check": "d_whisper_forward", "arch": whisper.name,
           "layers": [whisper.n_encoder_layers, whisper.n_layers],
           "frames": [1, WHISPER_FRAMES], "tokens": [1, n_dec],
           "params": n_params, "d_model": whisper.d_model,
           "heads": [whisper.n_heads, whisper.head_dim_],
           "d_ff": whisper.d_ff, "vocab": whisper.vocab_size,
           "compute_dtype": whisper.compute_dtype, "build_s": build_s,
           "forward_s": forward_s,
           "frames_per_s": WHISPER_FRAMES / float(np.median(forward_s)),
           "launches_per_forward": dict(no_launch, flash_attention=n_flash),
           "breakdown": breakdown, "peak_memory_gb": peak_gb,
           "d_kernel_vs_plain_bf16": cmp_b,
           "d_flash_calls_in_situ_rel": in_situ,
           "d_flash_call_shapes": shapes, "d_tol": TOL["bfloat16"],
           "d_float32_kernel_vs_plain": cmp_f32,
           "d_decode_vs_forward_f32": fvd}
    emit(row)
    assert len(calls) == n_flash, row
    assert shapes == sorted([(False, WHISPER_FRAMES, WHISPER_FRAMES),
                             (False, n_dec, WHISPER_FRAMES),
                             (True, n_dec, n_dec)]), row
    assert max(max(v) for v in in_situ.values()) <= TOL["bfloat16"], row
    assert cmp_f32["rel_all"] <= LOGIT_TOL["float32"], row
    assert fvd["rel"] <= fvd["tol"], row
    emit({"phase": phase, "check": "phase_total", "launches": total,
          "phase_s": time.perf_counter() - phase_t0})
    assert total["flash_attention"] == 3 * vl.n_layers + 3 * n_flash, total
    assert total["berrut_combine"] > 0 and total["mask_add"] > 0, total
    return total, flash_rows


# ---------------------------------------------------------------- phase 15
TRAIN_LM_ARCH = "phi3-mini-3.8b"
LM_SEQ = 4096
LM_BATCH = 8                        # global batch: 4 blocks x accum 2 x 1
LM_ACCUM = 2
LM_BLOCKS = 4
LM_STRAGGLERS = 1
LM_STEPS = 6
LM_LAYERS = 32                      # full depth (cut to 16 past 76 GB)
LM_LR = 3e-3                        # launch.train's default
LM_ROOM_GB = 72.0                   # ~66 GB reckoned, plus a margin
LM_PEAK_LIMIT_GB = 76.0
ENTRY_LAYERS = 1                    # (c): full width over 1 of 32 layers
ENTRY_ARGS = ["--arch", TRAIN_LM_ARCH, "--steps", "3", "--seq-len", "512",
              "--global-batch", "8", "--accum", "2", "--blocks", "4",
              "--coded", "--stragglers", "1", "--ckpt-every", "2",
              "--log-every", "1"]
# the backward kernel against its plain version: (B, Sq, Skv, H, KV, hd,
# hd_v, causal, softcap): ragged Sq and Skv, G in {1, 7}, hd 20, 64, 96,
# 128 and MLA's 192/128, softcap 20, causal, full and cross; then the
# routes' tile edges (bf16: 128 keys or queries a block, 64 a step, 32
# queries a dkdv step at 192/128; float32: 64 keys or queries a block, 32
# a step, 16 for dk and dq at 192/128): Sq and Skv of 63 to 257, unequal
# both ways, G 7, hd_v < hd, hd 160 padded to 192, softcap and GQA at
# 192/128
BWD_CHECKS = [(1, 65, 130, 2, 2, 64, 64, False, 0.0),
              (2, 130, 65, 14, 2, 96, 96, True, 0.0),
              (1, 200, 200, 7, 1, 128, 128, True, 0.0),
              (2, 200, 200, 7, 1, 20, 20, True, 0.0),
              (1, 257, 257, 7, 7, 96, 96, True, 20.0),
              (1, 70, 140, 2, 2, 192, 128, False, 0.0),
              (1, 300, 300, 16, 16, 192, 128, True, 0.0),
              (1, 128, 600, 4, 4, 64, 64, False, 0.0),
              (1, 127, 127, 4, 2, 96, 96, True, 0.0),
              (1, 128, 128, 7, 1, 96, 96, True, 0.0),
              (2, 129, 129, 4, 4, 64, 64, True, 20.0),
              (1, 257, 257, 7, 1, 96, 96, True, 0.0),
              (1, 129, 257, 4, 2, 128, 128, False, 0.0),
              (1, 257, 127, 4, 4, 96, 96, True, 0.0),
              (1, 127, 129, 4, 2, 128, 64, True, 0.0),
              (1, 63, 65, 4, 2, 96, 96, True, 0.0),
              (2, 97, 97, 6, 2, 192, 128, True, 20.0),
              (1, 33, 81, 4, 1, 192, 128, False, 0.0),
              (1, 150, 150, 8, 8, 160, 128, True, 0.0),
              (1, 100, 100, 4, 2, 72, 40, True, 0.0)]
# hd 20 in bfloat16 again, q, k, v and dout as views into 24-wide rows
# (48-byte strides, TMA) where the dense case's 40-byte rows load plainly
BWD_VIEWS = [(2, 200, 200, 7, 1, 20, 20, True, 0.0)]
BWD_MAIN = (1, LM_SEQ, LM_SEQ, 32, 32, 96, 96, True, 0.0)
# MLA's 192/128 prefill (deepseek-v2-lite's 16 heads): both routes at
# their widest, timed beside SDPA's backward
BWD_MLA = (1, 4096, 4096, 16, 16, 192, 128, True, 0.0)
BWD_GQA = (1, 257, 257, 7, 1, 96, 96, True, 0.0)   # determinism, GQA
BWD_TIMED = (BWD_MAIN, BWD_MLA)
BWD_RATE = {"bfloat16": BF16_TC, "float32": SPLIT_3XTF32}
# the float32 route's rms error against float64, at most this many times
# the plain float32 version's
RMS_RATIO = 2.0
LSE_TOL = 1e-5                      # of max |plain lse|
TRAIN_CLASSES = (("flash_fwd", ("flash_fwd",)),
                 ("flash_bwd", ("flash_bwd", "bwd_delta", "split_")),
                 ("cublas", ("gemm", "xmma", "cutlass", "nvjet")),
                 ("casts", ("copy_kernel",)))


def flash_bwd_work(b, sq, skv, h, kv, hd, hd_v, causal, elt,
                   products: int = 5) -> tuple:
    """(bytes, FLOP) of one attention backward: q, k, v, out and dout read
    and lse (float32) read once, dq, dk, dv written once; the products
    over the (query, key) pairs the mask keeps.  The function needs five
    (s and dq, dk over hd; dp and dv over hd_v); both routes' separate dq
    pass recomputes s and dp (seven), and above hd 96 the float32 route's
    separate dv pass s once more (eight)."""
    pairs = sum(min(skv, i + 1) for i in range(sq)) if causal else sq * skv
    nbytes = elt * (2 * b * sq * h * (hd + hd_v) +
                    2 * b * skv * kv * (hd + hd_v)) + 4 * b * sq * h
    per_pair = {5: 2 * (3 * hd + 2 * hd_v), 7: 2 * (4 * hd + 3 * hd_v),
                8: 2 * (5 * hd + 3 * hd_v)}[products]
    return nbytes, b * h * per_pair * pairs


def spills(report: str) -> int:
    """Spilled bytes (stores + loads) in one ptxas report line."""
    return sum(int(n) for n in
               re.findall(r"(\d+) bytes spill (?:stores|loads)", report))


def bwd_instantiations(ptxas: dict, hd: int, route: str) -> dict:
    """ptxas's report of the kernels one backward call launches: on the
    bf16 route the pre-pass and the dkdv and dq kernels at the template
    width hd rounds up to; on the 3xTF32 route the pre-pass's kernels and
    the passes at their padded width (dv and dk in one up to 96)."""
    if route == "wgmma":
        d = next(w for w in (16, 32, 64, 96, 128, 192) if hd <= w)
        names = ("bwd_delta_t_kernel<__nv_bfloat16>",
                 f"flash_bwd_dkdv_wgmma_kernel<{d}>",
                 f"flash_bwd_dq_wgmma_kernel<{d}>")
    else:   # kinds: 0 dv, 1 dk, 2 dq, 3 dv and dk in one pass (d <= 96)
        d = next(w for w in (32, 64, 96, 128, 192) if hd <= w)
        names = ("bwd_delta_t_kernel<float>", "split_rows_kernel",
                 "split_t_kernel") + tuple(
                     f"flash_bwd_3xtf32_kernel<{d}, {kind}>"
                     for kind in ((3, 2) if d <= 96 else (0, 1, 2)))

    def norm(name):
        return name.replace("(int)", "").replace(" ", "")
    found = {n: line for n in names for sym, line in ptxas.items()
             if norm(sym).endswith(norm(n))}
    assert len(found) == len(names), (names, list(ptxas))
    return found


def device_ms_by_kernel(torch, fn, want=(), calls: int = 5) -> dict:
    """{kernel name: device ms per call of ``fn``} over ``calls`` calls,
    from ``torch.profiler`` after one warm-up call: every kernel the call
    launches, its launches' times summed (the float32 pre-pass launches
    four row splits and three transposed ones a call).  A profile that
    recorded no event of a kernel named in ``want`` is taken again, up to
    PROFILE_TRIES times (``device_ms``'s note)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                              e.name)
                split[name] = split.get(name, 0.0) + \
                    e.time_range.elapsed_us() / calls / 1e3
        if all(any(w in name for name in split) for w in want):
            break
    return split


def sdpa_bwd_ms(torch, q, k, v, do) -> tuple:
    """(forward + backward, forward) ms of ``F.scaled_dot_product_attention``
    with ``is_causal`` on (B, S, H, hd) inputs, the backward fed ``do``:
    the library yardstick of the flash backward is their difference."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)
    return timed_ms(torch, fwd_bwd), timed_ms(torch, fwd)


def rms_vs_float64(torch, got, want64) -> float:
    """Root-mean-square of got - want64 over all three gradients, relative
    to the rms of want64 (float64)."""
    num = sum(float(((g.double() - w) ** 2).sum()) for g, w in
              zip(got, want64))
    den = sum(float((w ** 2).sum()) for w in want64)
    return (num / den) ** 0.5


def time_bwd(torch, q, k, v, out, lse, do, case, dname: str,
             kernels=()) -> dict:
    """The backward at a timed shape (BWD_TIMED): the kernel's time and
    each of its kernels' device time, the plain version's, SDPA's backward
    (forward + backward less forward; None where no backend takes the
    shape), the bound over the function's five products at the dtype's
    tensor-core rate and, apart, over the route's own products (seven; in
    float32 above hd 96 eight); in float32 also the rms error against the
    float64 plain version, the kernel's and the plain float32 version's.
    ``kernels``: the names of the kernels the call launches."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    b, sq, skv, h, kvh, hd, hd_v, causal, _ = case

    def kernel():
        return flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                          causal=causal)
    rate = BWD_RATE[dname]
    nbytes, flops = flash_bwd_work(b, sq, skv, h, kvh, hd, hd_v, causal,
                                   q.element_size())
    design = 7 if dname == "bfloat16" or hd <= 96 else 8
    _, flops_d = flash_bwd_work(b, sq, skv, h, kvh, hd, hd_v, causal,
                                q.element_size(), products=design)
    k_ms = timed_ms(torch, kernel, max_iters=20)
    try:
        fb_ms, f_ms = sdpa_bwd_ms(torch, q, k, v, do)
        library = {"library_ms": fb_ms - f_ms, "library_fwd_bwd_ms": fb_ms,
                   "library_fwd_ms": f_ms,
                   "library": "F.scaled_dot_product_attention, is_causal: "
                   "forward + backward less forward"}
    except RuntimeError as exc:       # no backend takes the shape
        library = {"library_ms": None, "library": "none",
                   "library_error": repr(exc)[:300]}
    row = dict(kernel_ms=k_ms, **library, **bound(nbytes, flops, rate),
               flop=flops, bytes=nbytes, tflop_per_s=flops / k_ms / 1e9,
               kernel_split_ms=device_ms_by_kernel(torch, kernel, kernels),
               design_products=design, design_flop=flops_d,
               design_bound_ms=bound(nbytes, flops_d, rate)["bound_ms"],
               bound_5_products_ms=bound(nbytes, flops, rate)["bound_ms"],
               plain_ms=timed_ms(
                   torch, lambda: ref.flash_attention_bwd_reference(
                       q, k, v, out, lse, do, causal), max_iters=3))
    if dname == "float32":
        want64 = ref.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal, acc=torch.float64)
        plain = ref.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                  causal)
        row["rms_err_vs_float64"] = rms_vs_float64(torch, kernel(), want64)
        row["plain_rms_err_vs_float64"] = rms_vs_float64(torch, plain,
                                                         want64)
        row["rms_ratio"] = row["rms_err_vs_float64"] / max(
            row["plain_rms_err_vs_float64"], 1e-300)
        del want64, plain
    return row


def check_flash_bwd(torch, gen, dev, ptxas: dict) -> dict:
    """Phase 15 (a): ``flash_attention_bwd`` against its plain version
    (``ref.flash_attention_bwd_reference``) on the forward kernel's own
    output and lse, over BWD_CHECKS, the training shape BWD_MAIN and MLA's
    BWD_MLA in float32 (the 3xTF32 route) and bfloat16 (the bf16 route),
    the route asserted, and BWD_VIEWS in bfloat16 through strided views:
    dq, dk, dv within TOL of max |plain|, the forward's lse within LSE_TOL
    of the plain forward's.  Each row names its route and ptxas's report
    of the kernels it launched; BWD_MAIN's and BWD_MLA's must not spill.
    At BWD_MAIN, BWD_GQA and every 192/128 case, in both dtypes, a second
    call must give the same bits.  At BWD_MAIN and BWD_MLA in both dtypes
    ``time_bwd``'s row (in float32 the rms error against float64 at most
    RMS_RATIO times the plain float32 version's).  Returns {"bfloat16":
    {"main": row, "mla_192_128": row}, "float32": {...}}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import (
        backward_route, flash_attention_bwd_kernel)
    timed = {"bfloat16": {}, "float32": {}}
    runs = [(case, dt, False) for case in BWD_CHECKS + list(BWD_TIMED)
            for dt in (torch.float32, torch.bfloat16)]
    runs += [(case, torch.bfloat16, True) for case in BWD_VIEWS]
    for case, dt, view in runs:
        b, sq, skv, h, kvh, hd, hd_v, causal, softcap = case
        dname = str(dt).split(".")[-1]
        shapes = ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd_v),
                  (b, sq, h, hd_v))
        pad = 4 if view else 0
        q, k, v, do = (torch.randn(sh[:3] + (sh[3] + pad,), generator=gen,
                                   device=dev).to(dt)[..., :sh[3]]
                       for sh in shapes)
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          softcap=softcap, return_lse=True)
        _, lse_p = ref.mha_reference(q, k, v, causal=causal,
                                     softcap=softcap, return_lse=True)
        route = backward_route(q, k, v, do)
        n0 = flash_attention_bwd_kernel.launches
        r0 = flash_attention_bwd_kernel.launches_by_route[route[0]]
        got = flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                         causal=causal, softcap=softcap)
        launched = (flash_attention_bwd_kernel.launches - n0,
                    flash_attention_bwd_kernel.launches_by_route[route[0]] -
                    r0)
        want = ref.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                 causal, softcap)
        torch.cuda.synchronize()
        assert launched == (1, 1), launched
        errs = {}
        for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
            assert g.shape == t.shape and g.dtype == t.dtype
            assert bool(torch.isfinite(g.float()).all()), name
            errs[name] = rel_diff(torch, g, w)
        lse_err = float((lse - lse_p).abs().max())
        kernels = bwd_instantiations(ptxas, hd, route[0])
        row = {"phase": "train_main_path", "check": "a_flash_bwd",
               "kernel": "flash_attention_bwd",
               "shape": dict(zip(("B", "Sq", "Skv", "H", "KV", "hd",
                                  "hd_v", "causal", "softcap"), case)),
               "dtype": dname, "route": route[0], "load_width": route[1],
               "strided_views": view, "ptxas": kernels,
               "max_abs_err": max(e[0] for e in errs.values()),
               "rel_err": {n: e[1] for n, e in errs.items()},
               "tol": TOL[dname], "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL * float(lse_p.abs().max()),
               "launches": launched[0]}
        del want, lse_p
        if (case in (BWD_MAIN, BWD_GQA) or hd > 128) and not view:
            again = flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                               causal=causal,
                                               softcap=softcap)
            torch.cuda.synchronize()
            row["bit_identical_second_call"] = all(
                torch.equal(x, y) for x, y in zip(got, again))
            del again
        del got
        if case in BWD_TIMED and not view:
            row.update(time_bwd(torch, q, k, v, out, lse, do, case, dname,
                                tuple(kernels)))
            timed[dname]["main" if case is BWD_MAIN else "mla_192_128"] = row
        emit(row)
        for name, (_, rel) in errs.items():
            assert rel <= TOL[dname], (name, row)
        assert lse_err <= row["lse_tol"], row
        assert row.get("bit_identical_second_call", True), row
        if case in BWD_TIMED:
            assert all(spills(line) == 0 for line in kernels.values()), row
        if "rms_ratio" in row:
            assert row["rms_ratio"] <= RMS_RATIO, row
        assert route[0] == ("wgmma" if dt == torch.bfloat16 else "3xtf32"), \
            row
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return timed


def grads_of_step(torch, model, tokens, targets, force_kernel):
    """One loss (``softmax_xent`` of the forward's logits) and backward,
    its gradients by parameter name."""
    from repro_torch.models.transformer import softmax_xent
    model.zero_grad(set_to_none=True)
    logits, _ = model(tokens, force_kernel=force_kernel)
    loss = softmax_xent(logits, targets)
    loss.backward()
    del logits
    return float(loss.detach()), {k: p.grad.clone()
                                  for k, p in model.named_parameters()}


def train_main_path(torch, dev) -> tuple:
    """Phase 15: LM training on the card, the path of ``python -m
    repro_torch.launch.train``.  (a) ``flash_attention_bwd`` against its
    plain version (``check_flash_bwd``), then a 2-layer full-width
    phi3-mini in float32 compute: one step's gradients through the
    kernels (its 2 backward calls on the 3xTF32 route) against the same
    step with ``force_kernel=False``, within 1e-4 of each leaf's max |g|.
    (b) phi3-mini-3.8b at full width and
    depth (3.82 B float32 parameters, bf16 compute, remat per layer)
    through ``steps.build_train_step`` with the trainer's AdamW
    (``warmup_cosine``), ``TokenPipeline`` batches and ``StragglerModel``
    masks: seq 4096, global batch 8, accum 2, 4 coded blocks (micro-batch
    1 x 4096), 1 straggler, 6 steps, each counted from zero (256 backward
    kernel calls and 512 forward launches a step: 32 layers x 8
    micro-batches, the forward twice under recomputation) and timed, the
    peak memory; every loss finite and the last below the first; one
    more step profiled (flash forward, flash backward, cuBLAS, casts, the
    rest; idle share).  (c) ``launch.train.main`` at full width over 1 of
    32 layers (``get_config`` mapped to it), killed after its step-2
    checkpoint and re-run, ends bit-identical (the SHA-256 of every array
    of its final checkpoint) to an uninterrupted run; the checkpoint's
    bytes and save and restore seconds.  (d) an encrypted checkpoint of
    one full-width layer's attention leaves, restored bit-identical, with
    every ``mask_add`` call held exactly.  Returns (the counted launches,
    the timed backward rows of (a) by dtype, the float32 step's backward
    launches under "float32", "launches").  Phase 15 alone:
    ``build_kernels(torch)`` then ``train_main_path(torch,
    torch.device("cuda"))``."""
    import contextlib
    import gc
    import io
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import BerrutGradientCode
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.straggler import StragglerModel
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel,
               "flash_attention_bwd": flash_attention_bwd_kernel}
    total = {k: 0 for k in kernels}
    no_launch = dict.fromkeys(kernels, 0)
    phase = "train_main_path"
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    cfg = dataclasses.replace(get_config(TRAIN_LM_ARCH), n_layers=LM_LAYERS)
    free_b, total_b = torch.cuda.mem_get_info()
    room = {"phase": phase, "check": "room", "free_gb": free_b / 1e9,
            "card_gb": total_b / 1e9, "asked_gb": LM_ROOM_GB,
            "params": cfg.param_count(),
            "state_gb_reckoned": 16 * cfg.param_count() / 1e9}
    emit(room)
    assert free_b / 1e9 >= LM_ROOM_GB, \
        f"phase 15 needs {LM_ROOM_GB} GB free on the card: {room}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    # ---- (a) the backward kernel, then a 2-layer float32 step (on the
    # 3xTF32 route)
    bwd_row = check_flash_bwd(torch, gen, dev,
                              _build_ptxas(torch, "flash_attention_bwd"))
    free()
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    model = build_model(cfg2, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_SEQ), generator=gen,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, (1, LM_SEQ), generator=gen,
                            device=dev)
    f0 = f32_flash_launches()
    b0 = flash_attention_bwd_kernel.launches_by_route["3xtf32"]
    (loss_k, g_k), got = counted(kernels, total, lambda: grads_of_step(
        torch, model, tokens, targets, None))
    F32_FLASH_LAUNCHES["15a_phi3_step"] = f32_flash_launches() - f0
    f32_bwd_launches = \
        flash_attention_bwd_kernel.launches_by_route["3xtf32"] - b0
    assert got == dict(no_launch, flash_attention=4,
                       flash_attention_bwd=2), got
    assert F32_FLASH_LAUNCHES["15a_phi3_step"] == 4
    assert f32_bwd_launches == 2
    bwd_row["float32"]["launches"] = f32_bwd_launches
    loss_p, g_p = grads_of_step(torch, model, tokens, targets, False)
    worst = {k: float((g_k[k] - g_p[k]).abs().max()) /
             max(float(g_p[k].abs().max()), 1e-30) for k in g_p}
    row = {"phase": phase, "check": "a_two_layer_f32_grads",
           "layers": 2, "tokens": [1, LM_SEQ], "launches": got,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "worst_leaf_rel": max(worst.values()),
           "worst_leaf": max(worst, key=worst.get), "tol": 1e-4}
    emit(row)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), row
    assert row["worst_leaf_rel"] <= 1e-4, row
    del model, g_k, g_p, tokens, targets
    free()

    # ---- (b) full width and depth: 6 coded steps
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)                      # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    opt = adamw(warmup_cosine(LM_LR, 20, LM_STEPS), weight_decay=0.01)
    state = opt.init(params)
    step_fn = build_train_step(model, opt, accum=LM_ACCUM,
                               gcode=BerrutGradientCode(LM_BLOCKS,
                                                        LM_BLOCKS))
    pipe = TokenPipeline(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    straggle = StragglerModel(LM_BLOCKS, LM_STRAGGLERS, seed=0)
    n_micro = LM_BLOCKS * LM_ACCUM
    want = dict(no_launch, flash_attention=2 * cfg.n_layers * n_micro,
                flash_attention_bwd=cfg.n_layers * n_micro)
    torch.cuda.reset_peak_memory_stats()
    rows, losses = [], []
    for i in range(LM_STEPS):
        mask = straggle.responder_mask(
            i, LM_BLOCKS - LM_STRAGGLERS).astype(np.float32)
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (params, state, metrics), got = counted(
            kernels, total, lambda: step_fn(params, state, batch, mask))
        loss = float(metrics["loss"])           # synchronizes
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        losses.append(loss)
        rows.append({"phase": phase, "check": "b_step", "step": i + 1,
                     "loss": loss, "responders": int(mask.sum()),
                     "wall_s": wall,
                     "tokens_per_s": LM_BATCH * LM_SEQ / wall,
                     "launches": got,
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                     / 1e9})
        emit(rows[-1])
        assert got == want, (got, want)
        assert np.isfinite(loss), rows[-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mask = straggle.responder_mask(
        LM_STEPS, LM_BLOCKS - LM_STRAGGLERS).astype(np.float32)
    batch = pipe.batch_at(LM_STEPS)
    breakdown = profile_device(
        torch, lambda: step_fn(params, state, batch, mask), TRAIN_CLASSES)
    walls = [r["wall_s"] for r in rows]
    row = {"phase": phase, "check": "b_training", "arch": cfg.name,
           "layers": cfg.n_layers, "params": n_params,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.head_dim_],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "seq": LM_SEQ, "global_batch": LM_BATCH, "accum": LM_ACCUM,
           "blocks": LM_BLOCKS, "stragglers": LM_STRAGGLERS,
           "build_s": build_s, "losses": losses, "step_wall_s": walls,
           "median_step_s": float(np.median(walls)),
           "median_tokens_per_s": LM_BATCH * LM_SEQ / float(np.median(walls)),
           "launches_per_step": want, "peak_memory_gb": peak_gb,
           "peak_limit_gb": LM_PEAK_LIMIT_GB, "breakdown": breakdown}
    emit(row)
    model_flops_row(phase, cfg, LM_SEQ, LM_BATCH, "train",
                    float(np.median(walls)))
    assert losses[-1] < losses[0], row
    assert peak_gb <= LM_PEAK_LIMIT_GB, row
    del model, params, state, step_fn, opt
    free()

    # ---- (c) launch.train.main, killed after its step-2 checkpoint
    class Killed(Exception):
        pass

    real_config, real_save = train_mod.get_config, train_mod.Checkpointer.save
    real_restore = train_mod.Checkpointer.restore
    timing = {"save_s": [], "restore_s": []}

    def timed_save(self, step, tree, extra=None):
        t = time.perf_counter()
        out = real_save(self, step, tree, extra)
        timing["save_s"].append(time.perf_counter() - t)
        return out

    def timed_restore(self, step, tree_like):
        t = time.perf_counter()
        out = real_restore(self, step, tree_like)
        torch.cuda.synchronize()
        timing["restore_s"].append(time.perf_counter() - t)
        return out

    def save_then_die(self, step, tree, extra=None):
        out = timed_save(self, step, tree, extra)
        if step == 2:
            raise Killed
        return out

    def final_manifest(folder: Path) -> dict:
        path = folder / "step_00000003"
        return dict(json.loads((path / "MANIFEST.json").read_text()),
                    bytes=(path / "arrays.npz").stat().st_size)

    ckpt_root = Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    out_log = io.StringIO()
    train_mod.get_config = lambda name: dataclasses.replace(
        real_config(name), n_layers=ENTRY_LAYERS)
    train_mod.Checkpointer.restore = timed_restore
    try:
        with contextlib.redirect_stdout(out_log):
            train_mod.Checkpointer.save = timed_save
            t = time.perf_counter()
            rc = train_mod.main(ENTRY_ARGS + ["--ckpt-dir",
                                              str(ckpt_root / "whole")])
            whole_s = time.perf_counter() - t
            assert rc == 0
            final = {"whole": final_manifest(ckpt_root / "whole")}
            shutil.rmtree(ckpt_root / "whole")      # ~7 GB of disk back
            free()
            train_mod.Checkpointer.save = save_then_die
            try:
                train_mod.main(ENTRY_ARGS + ["--ckpt-dir",
                                             str(ckpt_root / "cut")])
            except Killed:
                pass
            else:
                raise AssertionError("the run was not interrupted")
            free()
            train_mod.Checkpointer.save = timed_save
            rc = train_mod.main(ENTRY_ARGS + ["--ckpt-dir",
                                              str(ckpt_root / "cut")])
            assert rc == 0
        final["cut"] = final_manifest(ckpt_root / "cut")
    finally:
        train_mod.get_config = real_config
        train_mod.Checkpointer.save = real_save
        train_mod.Checkpointer.restore = real_restore
        shutil.rmtree(ckpt_root, ignore_errors=True)
        free()
    log = out_log.getvalue()
    row = {"phase": phase, "check": "c_entry_point",
           "argv": ENTRY_ARGS, "layers": ENTRY_LAYERS,
           "params": dataclasses.replace(
               get_config(TRAIN_LM_ARCH), n_layers=ENTRY_LAYERS)
           .param_count(),
           "uninterrupted_s": whole_s,
           "checkpoint_bytes": final["whole"]["bytes"],
           "arrays": final["whole"]["n_arrays"],
           "save_s": timing["save_s"], "restore_s": timing["restore_s"],
           "resumed": "resumed from checkpoint step 2" in log,
           "bit_identical": final["whole"]["hashes"] ==
           final["cut"]["hashes"],
           "log_tail": log.splitlines()[-4:]}
    emit(row)
    assert row["resumed"] and row["bit_identical"], row
    assert len(timing["restore_s"]) == 1, row

    # ---- (d) an encrypted checkpoint of one layer's attention leaves
    shapes = {"wq": (cfg.d_model, cfg.n_heads, cfg.head_dim_),
              "wk": (cfg.d_model, cfg.n_kv_heads, cfg.head_dim_),
              "wv": (cfg.d_model, cfg.n_kv_heads, cfg.head_dim_),
              "wo": (cfg.n_heads, cfg.head_dim_, cfg.d_model)}
    leaves = {k: torch.randn(shape, generator=gen, device=dev)
              / shape[0] ** 0.5 for k, shape in shapes.items()}
    held = []
    undo = hold_ops_mask_adds(torch, held)
    enc_dir = Path(tempfile.mkdtemp(prefix="ckpt_enc_", dir=ROOT / "build"))
    try:
        ck = Checkpointer(str(enc_dir), encrypt=True, secret=b"phase-15",
                          device=dev)
        t = time.perf_counter()
        _, got_save = counted(kernels, total, lambda: ck.save(1, leaves))
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back, got_restore = counted(
            kernels, total, lambda: Checkpointer(
                str(enc_dir), encrypt=True, secret=b"phase-15",
                device=dev).restore(1, leaves))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        nbytes = (enc_dir / "step_00000001" / "arrays.npz").stat().st_size
    finally:
        undo()
        shutil.rmtree(enc_dir, ignore_errors=True)
    same = all(torch.equal(back[k], leaves[k]) and
               back[k].device == leaves[k].device for k in leaves)
    row = {"phase": phase, "check": "d_encrypted_checkpoint",
           "params": sum(t.numel() for t in leaves.values()),
           "leaves": {k: list(s) for k, s in shapes.items()},
           "save_s": save_s, "restore_s": restore_s,
           "file_bytes": nbytes, "launches_save": got_save,
           "launches_restore": got_restore,
           "mask_add_calls_held": len(held),
           "held_exact": all(h[2] for h in held),
           "bit_identical": same}
    emit(row)
    assert same and row["held_exact"], row
    assert got_save["mask_add"] == got_restore["mask_add"] == len(leaves), row
    assert len(held) == 2 * len(leaves), row
    emit({"phase": phase, "check": "phase_total", "launches": total,
          "phase_s": time.perf_counter() - phase_t0})
    return total, bwd_row


# --------------------------------------------------------------------------
# phase 16: the sharded path on a 2 x 4 (data, model) mesh of gloo ranks
# --------------------------------------------------------------------------

P16_SEED = 16
P16_ARCH = "phi3-mini-3.8b"
P16_LAYERS = 4                      # of 32: 650 M parameters, full width
P16_MESH = (2, 4)                   # (data, model): 8 ranks on the card
P16_SEQ = 4096
P16_BLOCKS = 2                      # coded shards: one a data rank
P16_ACCUM = 2                       # 2 blocks x accum 2 x 1 x 4096 a step
P16_STEPS = 3                       # bf16 steps after the float32 one
# the float32 step drops the second data shard (coded_psum renormalizes
# the decode), then the bf16 steps (the second drops it), then one more
# bf16 step with every collective timed between device syncs
P16_MASKS = ((1.0, 0.0), (1.0, 1.0), (1.0, 0.0), (1.0, 1.0), (1.0, 1.0))
P16_LR = 3e-3
P16_GRAD_TOL = 1e-4                 # of each leaf's max |g|
P16_LOSS_RTOL = 1e-5
P16_DECODE_ARCH = "qwen2-7b"
P16_DECODE_LAYERS = 4               # of 28, float32, full width
P16_DECODE_BATCH = 4                # 2 a data rank
P16_DECODE_LEN = 4096               # the cache: 1024 positions a model rank
P16_DECODE_STEPS = 16               # at the cache's last 16 positions
P16_LOGIT_TOL = 1e-4                # of max |logits|
P16_SERVE = dict(batch=4, prompt_len=8, gen=16, seed=0,
                 check_agreement=False)
P16_LONG_CONTEXT = (16, 8192, 8)    # (c): batch, cache positions, steps
P16_ROOM_GB = 70.0
P16_TIMEOUT_S = 400.0
BF16_DENSE = 989e12                 # H100 SXM bf16 dense tensor-core peak


def model_flops_row(phase: str, cfg, seq: int, batch: int, kind: str,
                    seconds: float) -> dict:
    """``launch.roofline_math.model_flops`` of (cfg, a seq x batch shape
    of ``kind``) over ``seconds``: model FLOP/s and its share of the
    card's bf16 dense peak.  A printed line, not a gated metric."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.roofline_math import model_flops
    mf = model_flops(cfg, ShapeSpec(phase, seq, batch, kind))
    rate = mf["model_flops_global"] / seconds
    row = {"phase": phase, "check": "model_flops", "arch": cfg.name,
           "layers": cfg.n_layers, "kind": kind, "seq": seq,
           "batch": batch, "seconds": seconds, **mf,
           "model_tflop_per_s": rate / 1e12,
           "share_of_bf16_dense_989": rate / BF16_DENSE}
    emit(row)
    return row


def _set_cfg(model, **changes) -> None:
    """Every module's ``cfg`` with ``changes`` (the same weights): another
    compute dtype or KV cache dtype for a built model."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = dataclasses.replace(m.cfg, **changes)


def _flat(torch, tensors: dict) -> tuple:
    """(one float32 buffer holding every tensor of ``tensors``, each one's
    (name, offset, shape)): what phase 16 hands its ranks by CUDA IPC,
    one memory handle a tree instead of one a tensor."""
    total = sum(t.numel() for t in tensors.values())
    first = next(iter(tensors.values()))
    buf = torch.empty(total, dtype=torch.float32, device=first.device)
    index, off = [], 0
    with torch.no_grad():
        for name, t in tensors.items():
            buf[off:off + t.numel()].copy_(t.reshape(-1))
            index.append((name, off, tuple(t.shape)))
            off += t.numel()
    return buf, index


def _unflat(buf, index) -> dict:
    """``_flat``'s tensors back, as views of the buffer."""
    return {name: buf[off:off + math.prod(shape)].view(shape)
            for name, off, shape in index}


def _cache_tree(flat: dict) -> list:
    """``_flat``'s "<layer>.<leaf>" tensors of a cache back as the model's
    list of per-layer dicts."""
    out = []
    for name, t in flat.items():
        i, leaf = name.split(".")
        if int(i) == len(out):
            out.append({})
        out[int(i)][leaf] = t
    return out


def _filled_cache(torch, model, batch: int, max_len: int, upto: int, gen):
    """``model.init_cache(batch, max_len)`` with every k and v row before
    ``upto`` drawn from N(0, 1) by ``gen``: a long context to decode
    after, at the cost of no prefill."""
    cache = model.init_cache(batch, max_len)
    for layer in cache:
        for t in layer.values():
            t[:, :upto] = torch.randn(t[:, :upto].shape, generator=gen,
                                      device=t.device).to(t.dtype)
    return cache


def _with_params(model, buf, index):
    """A model whose parameters were moved to the meta device, given its
    parameters back as views of ``_flat``'s buffer."""
    from torch import nn
    for name, t in _unflat(buf, index).items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)[leaf] = nn.Parameter(t)
    return model


def _phase16_rank(rank, world, model, ref_grads, ref_loss, batches, masks,
                  decode_cfg, decode_cache, decode_tokens):
    """One rank of phase 16 (a) and (b), in its own process on the card:
    the kernels loaded (the parent built them), the collectives probed,
    the (data, model) mesh, then (a) the float32 coded step held against
    the one-process step's gradients and loss and the bf16 steps timed,
    and (b) the sequence-sharded decode from the parent's filled cache.
    ``model`` comes from the parent by CUDA IPC, a (meta-device model,
    ``_flat`` buffer, index) triple, as ``ref_grads`` and
    ``decode_cache`` (buffer, index) pairs; each rank keeps only its
    shards.  The decode model (8 GB in float32) does not cross: after
    (a) the ranks build it from ``decode_cfg`` and the parent's seed one
    at a time, each keeping its shards, so the parent holds no copy while
    (a)'s ranks run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import BerrutGradientCode
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import (P, NamedSharding, distribute,
                                           distribute_params)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    entered = time.time()
    sync = torch.cuda.synchronize
    _build.load_prebuilt()
    out = {"rank": rank, "probe": collectives.probe_cuda(dist.group.WORLD,
                                                         dev)}
    mesh = make_test_mesh(P16_MESH, ("data", "model"), device_type="cuda")
    out["coordinate"] = list(mesh.get_coordinate())
    model = distribute_params(_with_params(*model), mesh["model"])
    ref_grads = _unflat(*ref_grads)
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(P16_LR, 20, 100), weight_decay=0.01)
    state = opt.init(params)
    step = build_train_step(model, opt, accum=P16_ACCUM,
                            gcode=BerrutGradientCode(P16_BLOCKS, P16_BLOCKS),
                            dp_axes="data")

    def launches():
        return {**ops.kernel_launch_counts(),
                "flash_f32": flash_attention_kernel.launches_by_dtype[
                    "float32"],
                "bwd_3xtf32": flash_attention_bwd_kernel.launches_by_route[
                    "3xtf32"]}

    def delta(a, b):
        return {k: b[k] - a[k] for k in a}

    # ---- (a) the float32 step against the one-process step
    l0 = launches()
    collectives.reset()
    with use_mesh(mesh):
        t = time.perf_counter()
        params, state, metrics = step(params, state, batches[0], masks[0])
        loss = float(metrics["loss"])
        sync()
        out["f32_step_s"] = time.perf_counter() - t
    out["f32_launches"] = delta(l0, launches())
    out["f32_collectives"] = collectives.stats()
    worst = {}
    with torch.no_grad():
        for name, p in params.items():
            ref = ref_grads[name]
            mine = NamedSharding(p.device_mesh, None,
                                 p.placements).distribute(ref).to_local()
            worst[name] = float((p.grad.to_local() - mine).abs().max()) / \
                max(float(ref.abs().max()), 1e-30)
            del mine
    worst_leaf = max(worst, key=worst.get)
    out["f32"] = {"loss": loss, "ref_loss": ref_loss,
                  "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                  "worst_leaf_rel": worst[worst_leaf],
                  "worst_leaf": worst_leaf,
                  "placements": {k: str(p.placements)
                                 for k, p in list(params.items())[:6]}}

    # ---- (a) the bf16 steps: the last one with its collectives timed
    _set_cfg(model, compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    out["steps"] = []
    for i in range(1, len(batches)):
        timed = i == len(batches) - 1
        l0 = launches()
        collectives.reset()
        with use_mesh(mesh, timed=timed):
            sync()
            t = time.perf_counter()
            params, state, metrics = step(params, state, batches[i],
                                          masks[i])
            loss = float(metrics["loss"])
            sync()
            wall = time.perf_counter() - t
        st = collectives.stats()
        out["steps"].append({"loss": loss, "wall_s": wall, "timed": timed,
                             "mask": [float(m) for m in masks[i]],
                             "launches": delta(l0, launches()),
                             "collective_s": st["total"]["seconds"],
                             "collective_count": st["total"]["count"],
                             "collective_bytes": st["total"]["bytes"],
                             "collectives": st})
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, state, step, opt, model, metrics
    torch.cuda.empty_cache()

    # ---- (b) the sequence-sharded decode
    for r in range(world):
        if r == rank:
            decode_model = distribute_params(
                build_model(decode_cfg, device=dev, seed=P16_SEED), mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    cache = distribute(_cache_tree(_unflat(*decode_cache)),
                       decode_model.cache_specs(), mesh)
    out["cache_placements"] = str(cache[0]["k"].placements)
    out["cache_local_shape"] = list(cache[0]["k"].to_local().shape)
    toks = torch.as_tensor(decode_tokens, device=dev)
    start = P16_DECODE_LEN - decode_tokens.shape[1]
    logits, walls = [], []
    l0 = launches()
    collectives.reset()
    with torch.no_grad(), use_mesh(mesh):
        for t in range(decode_tokens.shape[1]):
            sync()
            t0 = time.perf_counter()
            tok = distribute(toks[:, t:t + 1], P("data", None), mesh)
            lg, cache = decode_model.decode_step(cache, tok, start + t)
            lg = lg.full_tensor()
            sync()
            walls.append(time.perf_counter() - t0)
            if rank == 0:
                logits.append(lg[:, 0].float().cpu().numpy())
    out["decode_launches"] = delta(l0, launches())
    out["decode_collectives"] = collectives.stats()
    out["decode_step_s"] = walls
    out["decode_logits"] = np.stack(logits) if rank == 0 else None
    out["rank_s"] = time.perf_counter() - t_start
    out["entered"], out["left"] = entered, time.time()
    return out


def sharded_main_path(torch, dev) -> tuple:
    """Phase 16: the sharded path on a 2 x 4 (data, model) mesh of 8 gloo
    ranks over the one card (``launch.mesh.run_ranks``; NCCL takes one
    rank a device).  Every rank first probes which gloo collectives serve
    CUDA tensors (``dist.collectives.probe_cuda``).  (a) phi3-mini-3.8b
    at full width over 4 of 32 layers: the parameters DTensors on
    ``mesh["model"]`` placed by ``param_specs`` (tensor parallel over
    heads, FFN width and vocabulary), one coded shard a data rank
    (``build_train_step(..., dp_axes="data")``), the gradients decoded
    over ``data`` by ``coded_psum``; each rank's attention runs the flash
    forward and backward kernels on its local heads (``local_map``).
    First one float32 step (the 3xTF32 kernels), its gradients within
    1e-4 of each leaf's max |g| and its loss within 1e-5 relative of the
    one-process step's (``steps.build_train_step`` on the same weights
    and batch, in this process); then 3 bf16 steps of 2 blocks x accum 2
    x 1 x 4096 tokens, the second's mask dropping a data shard: step
    wall, tokens/s, model FLOP/s (``roofline_math``), the collectives'
    seconds and bytes, the peak memory a rank.  (b) qwen2-7b at full
    width over 4 of 28 layers in float32: 16 decode steps with the batch
    over ``data`` and the cache's sequence over ``model`` (flash
    decoding), logits within 1e-4 of max |logits| of the one-process
    decode.  (c) phase 9 (c)'s coded serve (qwen2-7b, 8 of 28 layers,
    ``coded_layers="all"``) with the bf16 and the int8 KV cache: cache
    bytes, step p50/p99 and tok/s of each, ``berrut_combine`` launches,
    the int8 decode's logits against the bf16 cache's (reported).
    Returns (the counted launches, the float32 flash forward and
    backward launches of (a))."""
    import gc
    import tempfile

    import numpy as np
    from repro_torch.api import ClusterSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.core import BerrutGradientCode
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    from repro_torch.kernels.coded_matmul import coded_matmul_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    from repro_torch.kernels.mask_add import mask_add_kernel
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import attention, build_model
    from repro_torch.optim import adamw, warmup_cosine
    kernels = {"coded_matmul": coded_matmul_kernel,
               "berrut_combine": berrut_encode_kernel,
               "mask_add": mask_add_kernel,
               "flash_attention": flash_attention_kernel,
               "flash_attention_bwd": flash_attention_bwd_kernel}
    total = {k: 0 for k in kernels}
    phase = "sharded_main_path"
    phase_t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    free_b, total_b = torch.cuda.mem_get_info()
    room = {"phase": phase, "check": "room", "free_gb": free_b / 1e9,
            "card_gb": total_b / 1e9, "asked_gb": P16_ROOM_GB,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}
    emit(room)
    assert free_b / 1e9 >= P16_ROOM_GB, \
        f"phase 16 needs {P16_ROOM_GB} GB free on the card: {room}"

    # ---- (a) the one-process float32 step, its gradients kept
    cfg = dataclasses.replace(get_config(P16_ARCH), n_layers=P16_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg, seed=P16_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = TokenPipeline(cfg.vocab_size, P16_SEQ, P16_BLOCKS * P16_ACCUM,
                         seed=P16_SEED)
    batches = [{k: v.numpy() for k, v in pipe.batch_at(i).items()}
               for i in range(len(P16_MASKS))]
    masks = [np.asarray(m, np.float32) for m in P16_MASKS]
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = adamw(warmup_cosine(P16_LR, 20, 100), weight_decay=0.01)
    state = opt.init(params)
    one_step = build_train_step(model, opt, accum=P16_ACCUM,
                                gcode=BerrutGradientCode(P16_BLOCKS,
                                                         P16_BLOCKS))
    torch.cuda.synchronize()
    t = time.perf_counter()
    # the reference for (a)'s float32 step: its launches are reported,
    # not counted with the main path's
    (params, state, metrics), got = counted(
        kernels, dict.fromkeys(kernels, 0),
        lambda: one_step(params, state, batches[0], masks[0]))
    ref_loss = float(metrics["loss"])
    one_s = time.perf_counter() - t
    ref_grads = {k: p.grad.detach() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.grad = None
            p.copy_(start[k])
    del start, state, opt, one_step, metrics, params
    free()

    # ---- (b) the one-process decode
    dcfg = dataclasses.replace(get_config(P16_DECODE_ARCH),
                               n_layers=P16_DECODE_LAYERS,
                               compute_dtype="float32")
    dmodel = build_model(dcfg, seed=P16_SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(P16_SEED)
    dtoks = torch.randint(0, dcfg.vocab_size,
                          (P16_DECODE_BATCH, P16_DECODE_STEPS),
                          generator=gen, device=dev)
    start_pos = P16_DECODE_LEN - P16_DECODE_STEPS
    cache = _filled_cache(torch, dmodel, P16_DECODE_BATCH, P16_DECODE_LEN,
                          start_pos, gen)
    shared = {"cache": _flat(torch, {f"{i}.{k}": t
                                     for i, layer in enumerate(cache)
                                     for k, t in layer.items()})}
    ref_logits = []
    with torch.inference_mode():
        for t in range(P16_DECODE_STEPS):
            lg, cache = dmodel.decode_step(cache, dtoks[:, t:t + 1],
                                           start_pos + t)
            ref_logits.append(lg[:, 0].float().cpu().numpy())
    del cache
    free()

    # ---- the ranks: phi3 as one buffer (its parameters to meta); the
    # decode model is rebuilt in the ranks from its seed
    buf, index = _flat(torch, dict(model.named_parameters()))
    shared["model"] = (model.to("meta"), buf, index)   # new meta params
    shared["grads"] = _flat(torch, ref_grads)
    del ref_grads, model, dmodel
    free()
    before_s = time.perf_counter() - phase_t0
    rdv = tempfile.mkdtemp(prefix="rdv_", dir=ROOT / "build")
    t = time.perf_counter()
    spawned = time.time()
    try:
        outs = run_ranks(_phase16_rank, P16_MESH[0] * P16_MESH[1],
                         (shared["model"], shared["grads"], ref_loss,
                          batches, masks, dcfg, shared["cache"],
                          dtoks.cpu().numpy()),
                         rdv_dir=rdv, device="cuda", timeout_s=P16_TIMEOUT_S)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    ranks_s = time.perf_counter() - t
    # process start to the rank program, and its end to the join
    start_s = min(o["entered"] for o in outs) - spawned
    end_s = ranks_s - (max(o["left"] for o in outs) - spawned)
    del shared
    free()
    probe = outs[0]["probe"]
    emit({"phase": phase, "check": "gloo_cuda_collectives",
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "served": probe, "same_on_every_rank":
          all(o["probe"] == probe for o in outs)})
    assert all(v == "ok" for o in outs for v in o["probe"].values()), probe

    # (a) float32 step
    f32 = [o["f32"] for o in outs]
    f32_fwd = sum(o["f32_launches"]["flash_f32"] for o in outs)
    f32_bwd = sum(o["f32_launches"]["bwd_3xtf32"] for o in outs)
    per_rank = P16_LAYERS * P16_ACCUM       # backward calls; forwards 2x
    row = {"phase": phase, "check": "a_f32_step_vs_one_process",
           "arch": cfg.name, "layers": P16_LAYERS, "params": n_params,
           "mesh": list(P16_MESH), "tokens_per_step":
           P16_BLOCKS * P16_ACCUM * P16_SEQ,
           "loss_mesh": f32[0]["loss"], "loss_one_process": ref_loss,
           "loss_rel": max(r["loss_rel"] for r in f32),
           "worst_leaf_rel": max(r["worst_leaf_rel"] for r in f32),
           "worst_leaf": max(f32, key=lambda r: r["worst_leaf_rel"])[
               "worst_leaf"],
           "grad_tol": P16_GRAD_TOL, "loss_rtol": P16_LOSS_RTOL,
           "placements_rank0": f32[0]["placements"],
           "one_process_step_s": one_s, "one_process_launches": got,
           "mesh_step_s": max(o["f32_step_s"] for o in outs),
           "flash_f32_launches": f32_fwd, "bwd_3xtf32_launches": f32_bwd,
           "collectives_rank0": outs[0]["f32_collectives"]}
    emit(row)
    assert row["loss_rel"] <= P16_LOSS_RTOL, row
    assert row["worst_leaf_rel"] <= P16_GRAD_TOL, row
    # a layer's forward twice (remat), its backward once, a micro-batch
    assert all(o["f32_launches"]["flash_f32"] == 2 * per_rank and
               o["f32_launches"]["bwd_3xtf32"] == per_rank
               for o in outs), row

    # (a) the bf16 steps
    launched = {k: 0 for k in kernels}
    for o in outs:
        for s_ in o["steps"]:
            for k in kernels:
                launched[k] += s_["launches"][k]
    for k, v in launched.items():
        total[k] += v
    tokens = P16_BLOCKS * P16_ACCUM * P16_SEQ
    n_steps = len(P16_MASKS) - 1
    walls = [max(o["steps"][i]["wall_s"] for o in outs)
             for i in range(n_steps)]
    steps = []
    for i in range(n_steps):
        coll = [o["steps"][i] for o in outs]
        steps.append({"step": i + 1, "loss": coll[0]["loss"],
                      "mask": coll[0]["mask"], "wall_s": walls[i],
                      "tokens_per_s": tokens / walls[i],
                      "collectives_timed": coll[0]["timed"],
                      "collective_count_rank0": coll[0]["collective_count"],
                      "collective_bytes_rank0": coll[0]["collective_bytes"],
                      "collectives_rank0": coll[0]["collectives"]})
    # the last step: every collective between two device syncs (slower
    # than the untimed steps; its seconds are the collectives' own)
    timed = [o["steps"][-1] for o in outs]
    steps[-1].update({
        "collective_s_max_rank": max(c["collective_s"] for c in timed),
        "collective_s_mean_rank": float(np.mean(
            [c["collective_s"] for c in timed])),
        "collective_share_of_wall_mean_rank": float(np.mean(
            [c["collective_s"] / c["wall_s"] for c in timed]))})
    walls = walls[:P16_STEPS]           # the untimed steps
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    med = float(np.median(walls))
    flops = model_flops_row(phase, bcfg, P16_SEQ,
                            P16_BLOCKS * P16_ACCUM, "train", med)
    want = {"flash_attention": 2 * per_rank * n_steps * len(outs),
            "flash_attention_bwd": per_rank * n_steps * len(outs)}
    row = {"phase": phase, "check": "a_bf16_coded_steps",
           "arch": cfg.name, "layers": P16_LAYERS, "params": n_params,
           "mesh": list(P16_MESH), "blocks": P16_BLOCKS,
           "accum": P16_ACCUM, "seq": P16_SEQ, "steps": steps,
           "median_step_s_untimed": med,
           "median_tokens_per_s_untimed": tokens / med,
           "timed_step_s": steps[-1]["wall_s"],
           "model_tflop_per_s": flops["model_tflop_per_s"],
           "share_of_bf16_dense_989": flops["share_of_bf16_dense_989"],
           "launches": launched, "expected_launches": want,
           "peak_memory_gb_per_rank": [o["peak_memory_gb"] for o in outs],
           "rank_s": [o["rank_s"] for o in outs], "ranks_call_s": ranks_s,
           "ranks_start_s": start_s, "ranks_end_s": end_s,
           "before_ranks_s": before_s}
    emit(row)
    assert all(np.isfinite(s_["loss"]) for s_ in steps), row
    assert all(launched[k] == v for k, v in want.items()), row
    assert launched["berrut_combine"] == launched["coded_matmul"] == 0, row

    # (b) the sequence-sharded decode
    got_logits = outs[0]["decode_logits"]
    rel = [float(np.abs(got_logits[t] - ref_logits[t]).max())
           / float(np.abs(ref_logits[t]).max())
           for t in range(P16_DECODE_STEPS)]
    dwalls = outs[0]["decode_step_s"]
    row = {"phase": phase, "check": "b_sequence_sharded_decode",
           "arch": dcfg.name, "layers": P16_DECODE_LAYERS,
           "compute_dtype": "float32", "batch": P16_DECODE_BATCH,
           "cache_len": P16_DECODE_LEN, "steps": P16_DECODE_STEPS,
           "first_pos": P16_DECODE_LEN - P16_DECODE_STEPS,
           "cache_placements": outs[0]["cache_placements"],
           "cache_local_shape_rank0": outs[0]["cache_local_shape"],
           "max_rel_logits": max(rel), "tol": P16_LOGIT_TOL,
           "step_ms_p50": float(np.percentile(dwalls, 50)) * 1e3,
           "step_ms_p99": float(np.percentile(dwalls, 99)) * 1e3,
           "tok_s": P16_DECODE_BATCH / float(np.median(dwalls)),
           "launches_rank0": outs[0]["decode_launches"],
           "collectives_rank0": outs[0]["decode_collectives"]}
    emit(row)
    assert max(rel) <= P16_LOGIT_TOL, row
    assert outs[0]["cache_placements"] == "(Shard(dim=0), Shard(dim=1))"

    # ---- (c) the int8 KV cache in phase 9 (c)'s coded serve
    base = dataclasses.replace(get_config(SERVE_ARCH),
                               n_layers=SERVE_ALL_LAYERS)
    spec_all = ClusterSpec.serve_deadline(coded_layers="all")
    sites = 4 * SERVE_ALL_LAYERS + 1
    serve_rows = {}
    slots = spec_all.serve.max_slots
    max_len = P16_SERVE["prompt_len"] + P16_SERVE["gen"]
    for name, cache_dtype in (("bf16", ""), ("int8", "int8")):
        cfg_c = dataclasses.replace(base, kv_cache_dtype=cache_dtype)
        cache_bytes = sum(
            t.numel() * t.element_size()
            for t in attention.init_kv_cache(cfg_c, slots, max_len,
                                             device="meta").values()) \
            * cfg_c.n_layers
        with Session(spec_all, device=dev) as s:
            rep, launched = counted(kernels, total, lambda: s.serve(
                arch=cfg_c, **P16_SERVE))
            if name == "int8":
                smodel = next(iter(s._serve_models.values()))
        n_steps = len(rep.step_stats)
        serve_rows[name] = {"kv_cache_dtype": cache_dtype or "bfloat16",
                            "cache_bytes": cache_bytes,
                            "cache_shape": [slots, max_len],
                            **serve_summary(rep), "launches": launched}
        assert launched["berrut_combine"] == sites * (1 + n_steps), \
            (name, launched)
        del s, rep
        free()
    # the int8 decode's logits against the bf16 cache's, same weights:
    # reported, not held (a different quantization)
    toks = torch.randint(0, base.vocab_size, (2, 8), generator=gen,
                         device=dev)
    out = {}
    with torch.inference_mode():
        for name, cache_dtype in (("int8", "int8"), ("bf16", "")):
            _set_cfg(smodel, kv_cache_dtype=cache_dtype)
            cache = smodel.init_cache(2, 8)
            rows = []
            for t in range(8):
                lg, cache = smodel.decode_step(cache, toks[:, t:t + 1], t)
                rows.append(lg[:, 0].float())
            out[name] = torch.stack(rows)
    err = float((out["int8"] - out["bf16"]).abs().max())
    scale = float(out["bf16"].abs().max())
    agree = float((out["int8"].argmax(-1) == out["bf16"].argmax(-1))
                  .float().mean())
    del out, cache
    free()
    # the two caches at a long context, the same weights: one decode
    # step's ms (CUDA events), bf16, int8, int8, bf16.  Both decodes read
    # the whole cache into a float32 copy (as the reference's do), the
    # int8 one through its scales.
    lb, ll, _ = P16_LONG_CONTEXT
    long_ms = {"bf16": [], "int8": []}
    long_bytes = {}
    tok = toks[:1, :1].expand(lb, 1).contiguous()
    with torch.inference_mode():
        for name in ("bf16", "int8", "int8", "bf16"):
            _set_cfg(smodel, kv_cache_dtype="int8" if name == "int8" else "")
            cache = smodel.init_cache(lb, ll)
            long_bytes[name] = sum(t.numel() * t.element_size()
                                   for layer in cache for t in layer.values())
            long_ms[name].append(timed_ms(
                torch, lambda: smodel.decode_step(cache, tok, ll - 1),
                max_iters=P16_LONG_CONTEXT[2]))
            del cache
            free()
    kv = base.n_kv_heads_padded * base.head_dim_
    long_row = {"batch": lb, "positions": ll,
                "cache_bytes": long_bytes,
                "float32_copy_bytes_per_step": 2 * lb * ll * kv * 4
                * SERVE_ALL_LAYERS,
                "step_ms": long_ms,
                "int8_over_bf16_ms": float(np.mean(long_ms["int8"])
                                           / np.mean(long_ms["bf16"]))}
    del smodel
    free()
    row = {"phase": phase, "check": "c_int8_kv_cache_serve",
           "arch": base.name, "layers": SERVE_ALL_LAYERS,
           "coded_layers": "all", "sites_per_step": sites,
           "workload": P16_SERVE, **{k: v for k, v in serve_rows.items()},
           "cache_bytes_ratio": serve_rows["int8"]["cache_bytes"]
           / serve_rows["bf16"]["cache_bytes"],
           "int8_vs_bf16_logits_max_abs": err,
           "int8_vs_bf16_logits_rel": err / scale,
           "int8_vs_bf16_argmax_agreement": agree,
           "long_context": long_row}
    emit(row)
    emit({"phase": phase, "check": "phase_total", "launches": total,
          "phase_s": time.perf_counter() - phase_t0})
    return total, {"flash_f32": f32_fwd, "bwd_3xtf32": f32_bwd}


def _build_ptxas(torch, stem: str) -> dict:
    """ptxas's report of ``csrc/<stem>.cu`` (``build_kernels`` format)."""
    from repro_torch.kernels import _build
    cu_filt = str(Path(_build._nvcc()).with_name("cu++filt"))
    return demangled(ptxas_report(_build.build_log.get(stem, "")), cu_filt)


def run_one(spec, a, b, worker_t=None):
    """One round of ``spec`` in a fresh session on A's device (seeded with
    ``worker_t``, the measured per-worker compute time, when given)."""
    from repro_torch.api import Session
    with Session(spec, device=a.device) as s:
        if worker_t is not None:
            s.engine._worker_t = dict(worker_t)
        return s.matmul(a, b)


if __name__ == "__main__":
    sys.exit(main())
