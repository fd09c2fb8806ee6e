#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

The main path is one SPACDC coded round,
``repro_torch.api.Session(ClusterSpec.paper_fig3()).matmul(a, b)`` (N=30
workers, K=24 blocks, T=3 noise blocks, S=7 stragglers), which runs two
hand-written CUDA kernels: ``coded_matmul`` (encode + all N worker
products) and ``berrut_combine`` (the masked decode).  Phases, one JSON
line each:

1. device and build: the card's name and power limit (``nvidia-smi``), TF32
   off, both kernels built by ``nvcc`` from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version on the card (float32 and
   bfloat16, ragged shapes and the main path's shapes), with its time, the
   plain version's time and one PyTorch call's time (``library_ms``, a
   yardstick the port never calls);
3. the main path: three rounds each of the fig-3 backprop job, fig3_wide and
   the full qwen2-7b FFN up-projection width (12288x3584 @ 3584x18944), each
   held against the same round through the plain versions and against the
   exact product; every round must launch each kernel exactly once.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then non-zero and no result line is printed.  The script imports
nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (see PERF.md): device memory and float32 on the
# CUDA cores; bf16 dense tensor-core rate for bfloat16 inputs
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

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


def rel_diff(torch, got, want) -> tuple:
    """(max |got - want|, that over max |want|), in float32."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def bound(nbytes: float, flops: float, flop_rate: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    ptxas = {stem: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
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
        b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S
                           if dt == torch.float32 else BF16_FLOP_PER_S)
        row = {"phase": "kernel_vs_plain", "kernel": "coded_matmul",
               "shape": {"N": n, "J": j, "blk": blk, "d": d, "n_out": n_out},
               "dtype": dname, "max_abs_err": err, "rel_err": rel,
               "tol": TOL[dname], "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "launches": launched}
        emit(row)
        assert rel <= TOL[dname], row
        results[("coded_matmul", n, j, blk, d, n_out, dname)] = row

        # the decode of these worker results (the 24 x 30 fig-3 decode when
        # N = 30; N = 33 walks Q = 31 > 24 rows)
        q_w = dec_w if n == 30 else randn(max(n - 2, 1), n)
        results[("berrut_combine", n, blk * n_out, dname)] = check_combine(
            torch, emit, q_w, got.reshape(n, -1))
        del got, want, a, b
    # a J = 200 slab walk and a Q > 32 chunk walk
    check_combine(torch, emit, randn(8, 200), randn(200, 100003))
    check_combine(torch, emit, randn(40, 30),
                  randn(30, 5000, dtype=torch.bfloat16))
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 3. main path
    spec = ClusterSpec.paper_fig3()
    plain_spec = dataclasses.replace(
        spec, code=dataclasses.replace(spec.code, use_kernel=False))
    berrut_encode_kernel.launches = 0
    coded_matmul_kernel.launches = 0
    for name, m, d, n_out in MAIN_SHAPES:
        a = randn(m, d)
        b = randn(d, n_out)
        exact = torch.matmul(a, b)
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
                       "stats_plain": dataclasses.asdict(st_p)}
                emit(row)
                assert rel <= ROUND_TOL, row
                assert abs(rel_k - rel_p) <= ROUND_TOL, row
                del out_k, out_p
        del a, b, exact
        torch.cuda.empty_cache()
    launches = {"coded_matmul": coded_matmul_kernel.launches,
                "berrut_combine": berrut_encode_kernel.launches}
    assert launches == {"coded_matmul": 9, "berrut_combine": 9}, launches

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
             "src/repro/kernels/berrut_encode.py:61")):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def check_combine(torch, emit, w, payload) -> dict:
    """berrut_combine kernel vs plain version on one (Q, J) x (J, M) case."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.berrut_encode import berrut_encode_kernel
    q, j = w.shape
    m = payload.shape[1]
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
    k_ms = timed_ms(torch, lambda: berrut_encode_kernel(w, payload))
    p_ms = timed_ms(torch, lambda: ref.berrut_combine(w, payload))
    lib_ms = (timed_ms(torch, lambda: torch.matmul(w, payload))
              if dt == torch.float32 else None)
    elt = payload.element_size()
    nbytes = 4 * q * j + elt * (j * m + q * m)
    b_ms, b_by = bound(nbytes, 2 * q * j * m, F32_FLOP_PER_S
                       if dt == torch.float32 else BF16_FLOP_PER_S)
    row = {"phase": "kernel_vs_plain", "kernel": "berrut_combine",
           "shape": {"Q": q, "J": j, "M": m}, "dtype": dname,
           "max_abs_err": err, "rel_err": rel, "tol": TOL[dname],
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "launches": launched}
    emit(row)
    assert rel <= TOL[dname], row
    return row


if __name__ == "__main__":
    sys.exit(main())
