#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

Five main paths.  Two are SPACDC coded rounds through
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

Phases, one JSON line each:

1. device and build: the card's name and power limit (``nvidia-smi``), TF32
   off, all four kernels built by ``nvcc`` from
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
   causal and full; at the qwen2-7b prefill shape in float32, the CUDA-core
   kernel of phase 6 c, and bfloat16), with its time, the plain version's
   time and one
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
   seconds.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then non-zero and no result line is printed.  The script imports
nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
    call, which sets ``timed_ms`` for small shapes.  None when the
    profiler records no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / len(us) / 1e3 if us else None


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library("coded_matmul")
    build_s = time.perf_counter() - t0
    assert _build.build_count == 1, _build.build_count
    # every source's log, whether this process compiled it or found it built
    cu_filt = str(Path(_build._nvcc()).with_name("cu++filt"))
    ptxas = {stem: demangled(ptxas_report(log), cu_filt)
             for stem, log in _build.build_log.items()}
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
               "bound_ms_f32_cuda_cores": bound(nbytes, flops,
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


# flash_attention cases, (B, Sq, Skv, H, KV, hd, causal, softcap): ragged
# and unequal Sq, Skv, every head dim the kernel pads, G in {1, 7}, softcap
FLASH_CASES = [(1, 65, 130, 2, 2, 48, False, 0.0),
               (1, 65, 130, 2, 2, 48, True, 0.0),
               (2, 130, 65, 14, 2, 96, True, 0.0),
               (1, 256, 256, 4, 4, 128, False, 0.0),
               (1, 300, 300, 8, 2, 64, True, 20.0)] + \
    [(2, 200, 200, 7, 1, hd, True, 0.0)
     for hd in (16, 20, 32, 48, 64, 96, 128)]
# qwen2-7b prefill: B = 1, S = 4096, H = 28, KV = 4, hd = 128, causal
FLASH_MAIN = (1, 4096, 4096, 28, 4, 128, True, 0.0)
MODEL_TOKENS = 4096
# forward logits, kernel against plain: bfloat16 compute (28 layers of
# bfloat16 activations) and float32 compute (2 layers), of max |plain|
LOGIT_TOL = {"bfloat16": 5e-2, "float32": 1e-4}


def flash_work(b, sq, skv, h, kv, hd, causal, elt) -> tuple:
    """(bytes, FLOP) of one attention forward: q, k, v read and out written
    once; both products over the (query, key) pairs the mask keeps."""
    pairs = sum(min(skv, i + 1) for i in range(sq)) if causal else sq * skv
    return (elt * (2 * b * sq * h * hd + 2 * b * skv * kv * hd),
            4 * b * h * hd * pairs)


def check_flash(torch, gen, dev, ptxas: dict) -> dict:
    """flash_attention kernel vs ``ref.mha_reference`` over FLASH_CASES in
    float32 and bfloat16, then at the qwen2-7b prefill shape in float32
    (the CUDA-core kernel of phase 6's 2-layer float32 check) and bfloat16,
    each timed beside the plain version and ``scaled_dot_product_attention``.
    Returns the bfloat16 main row, which carries the kernel's ptxas report."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     load_width)

    def inputs(case, dt):
        b, sq, skv, h, kv, hd = case[:6]
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                     for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                                   (b, skv, kv, hd)))

    worst = {}
    for case in FLASH_CASES + [FLASH_MAIN]:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            causal, softcap = case[6], case[7]
            q, k, v = inputs(case, dt)
            n0 = flash_attention_kernel.launches
            got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
            launched = flash_attention_kernel.launches - n0
            want = ref.mha_reference(q, k, v, causal=causal, softcap=softcap)
            torch.cuda.synchronize()
            assert launched == 1, launched
            assert got.shape == want.shape and got.dtype == want.dtype
            assert bool(torch.isfinite(got.float()).all())
            err, rel = rel_diff(torch, got, want)
            row = {"phase": "kernel_vs_plain", "kernel": "flash_attention",
                   "shape": dict(zip(("B", "Sq", "Skv", "H", "KV", "hd",
                                      "causal", "softcap"), case)),
                   "dtype": dname, "max_abs_err": err, "rel_err": rel,
                   "tol": TOL[dname], "launches": launched}
            if dt == torch.bfloat16:
                width = load_width(q, k, v)
                row["loads"] = ("tma" if width == 16 else
                                f"plain {width}-byte")
            worst[dname] = max(worst.get(dname, 0.0), rel)
            if case is not FLASH_MAIN:
                assert rel <= TOL[dname], row
                continue
            # the main shape: the bf16 row is the forward's (phase 6 a),
            # the float32 row the 2-layer float32 check's (phase 6 c)
            k_ms = timed_ms(torch, lambda: flash_attention_kernel(
                q, k, v, causal=causal))
            p_ms = timed_ms(torch, lambda: ref.mha_reference(
                q, k, v, causal=causal))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            nbytes, flops = flash_work(*case[:7], q.element_size())
            row.update(kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       **bound(nbytes, flops, BF16_TC
                               if dt == torch.bfloat16 else F32_CUDA),
                       flop=flops, bytes=nbytes,
                       tflop_per_s=flops / k_ms / 1e9,
                       worst_rel_err_by_dtype=worst, ptxas=ptxas)
            emit(row)
            assert rel <= TOL[dname], row
            del q, k, v, got, want, qt, kt, vt
            torch.cuda.empty_cache()
            if dt == torch.bfloat16:
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
        got2, _ = model2(tokens)
        assert counts()["flash_attention"] - c0["flash_attention"] == 2
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
    assert rel_b <= LOGIT_TOL["bfloat16"], row
    assert rel_c <= LOGIT_TOL["float32"], row
    assert excess_d <= 0.0, row
    return launches


def forward_vs_decode(torch, model, tokens, n: int = 16) -> tuple:
    """The forward's logits on the first n tokens against n teacher-forced
    ``decode_step`` calls: (max |diff|, max of |diff| - (0.05 + 0.05 *
    |forward|)), which is <= 0 when they agree to atol = rtol = 0.05."""
    full, _ = model(tokens[:, :n])
    cache = model.init_cache(1, n)
    steps = []
    for t in range(n):
        step, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
        steps.append(step[:, 0])
    inc = torch.stack(steps, dim=1).float()
    full = full.float()
    diff = (inc - full).abs()
    return float(diff.max()), float((diff - (0.05 + 0.05 * full.abs())).max())


# device kernel classes of a profile, (class, name substrings), first match
# wins, the rest is "other": the forward's (phase 6) and a training step's
# (phase 7: coded_matmul is three kernels)
FORWARD_CLASSES = (("flash_attention", ("flash_fwd",)),
                   ("matmul", ("gemm", "xmma", "cutlass", "nvjet")),
                   ("casts", ("copy_kernel",)))   # dtype casts, layout copies
STEP_CLASSES = (("berrut_combine", ("berrut_stream",)),
                ("coded_matmul", ("encode_split_kernel", "split_b_kernel",
                                  "gemm_3xtf32_kernel")),
                ("mask_add", ("mask_add",)),
                ("cublas", ("gemm", "xmma", "cutlass", "nvjet")))


def profile_device(torch, fn, classes) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    class, the top kernels, and the device's idle share of the span from
    its first kernel's start to its last kernel's end and of the host's
    wall time.  Outside the counted main paths."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {key: 0.0 for key, _ in classes}
    by_class["other"] = 0.0
    top = {}
    first, last = float("inf"), float("-inf")
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        first = min(first, e.time_range.start)
        last = max(last, e.time_range.end)
        low = e.name.lower()
        key = next((k for k, subs in classes
                    if any(w in low for w in subs)), "other")
        by_class[key] += ms
        top[e.name[:90]] = top.get(e.name[:90], 0.0) + ms
    busy = sum(by_class.values())
    span_ms = (last - first) / 1e3 if busy else 0.0
    return {"device_ms_by_class": by_class, "device_busy_ms": busy,
            "device_span_ms": span_ms, "profiled_wall_ms": wall_ms,
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


def combine_bound_ratio(torch, w, blocks, got, want) -> float:
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
    the float64 temporaries of a large call stay near 0.5 GB each."""
    assert blocks.dtype == got.dtype == want.dtype == torch.float32
    j = blocks.shape[0]
    w64 = torch.as_tensor(w).to(device=got.device,
                                dtype=torch.float32).double()
    flat = blocks.reshape(j, -1)
    got, want = got.reshape(w64.shape[0], -1), want.reshape(w64.shape[0], -1)
    gamma2 = 2 * j * U32 / (1 - j * U32)
    step = max(1, (1 << 26) // max(w64.shape[0], 1))
    worst = 0.0
    for c in range(0, flat.shape[1], step):
        limit = (w64.abs() @ flat[:, c:c + step].double().abs()) * gamma2
        diff = (got[:, c:c + step].double() -
                want[:, c:c + step].double()).abs()
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
        run_training(torch, dev, k_spec, sizes, data, kernels, ratios)
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
        # the held run makes the kernel run's berrut_combine calls and the
        # profiled step's: (TRAIN_STEPS + 1) steps' worth, and the warm-up
        per_round = ROUND_LAUNCHES[scheme]["berrut_combine"]
        assert len(ratios) == per_round * (len(sizes) - 2) * \
            (TRAIN_STEPS + 2), row
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


def hold_prefix_decodes(torch, ratios: list):
    """Make every ``ops.prefix_decode`` call also run the plain version on
    the same inputs and append their ``combine_bound_ratio`` to
    ``ratios``.  Returns the function that undoes it."""
    from repro_torch.kernels import ops
    run = ops.prefix_decode

    def prefix_decode(weights, results, *, force_kernel=None):
        got = run(weights, results, force_kernel=force_kernel)
        want = run(weights, results, force_kernel=False)
        e, k, n = weights.shape
        ratios.append(combine_bound_ratio(torch, weights.reshape(e * k, n),
                                          results, got, want))
        return got
    ops.prefix_decode = prefix_decode

    def undo():
        ops.prefix_decode = run
    return undo


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
            undo = hold_prefix_decodes(torch, ratios)
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


if __name__ == "__main__":
    sys.exit(main())
