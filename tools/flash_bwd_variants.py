"""Alternated A/B timing of variants of the bf16 flash attention backward.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with a few text replacements, built beside the repo's own library with the
same nvcc flags and swapped in for it as the wrapper's launch function.
Every build is first held against the plain version
(``kernels.ref.flash_attention_bwd_reference``) on a few small cases
within 2e-2 of max |plain|, then timed at phi3-mini's training shape
(1 x 4096, 32 heads of 96, causal) by CUDA events, in the order base,
variants, variants reversed, base, so that a drift of the card's clock
falls on both sides.

    python3 tools/flash_bwd_variants.py          # needs one H100 and nvcc

Prints ptxas's registers and spills of every build, one JSON line per
check and per timing, and a last JSON line with each build's best and
all times.

The variants:
  * ``stages3``: a ring of three stages in place of two (both kernels);
  * ``dq128``: the dq pass streams 128 keys a stage in place of 64 (N =
    128 for S and dP, 8 K-steps for dQ += dS K).
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
OUT_DIR = ROOT / "build" / "flash_bwd_variants"
MAIN = (1, 4096, 32, 96)        # B, S, H (= KV), hd; causal
CASES = [  # B, Sq, Skv, H, KV, hd, hd_v, causal
    (1, 200, 200, 7, 1, 96, 96, True),
    (2, 130, 65, 14, 2, 96, 96, True),
    (1, 128, 600, 4, 4, 64, 64, False),
    (1, 127, 129, 4, 2, 128, 64, True),
]
TOL = 2e-2

DQ_KERNEL = ("flash_bwd_dq_wgmma_kernel(const", "\n}\n")
LAUNCH = ("int launch_d(const Args& a", "\n}\n")
# (region (first marker, end marker) or None for the whole file, old, new,
#  how many times old occurs there)
VARIANTS = {
    "stages3": [
        (None, "constexpr int kStages = 2;", "constexpr int kStages = 3;", 1),
    ],
    "dq128": [
        (None, "template <int KC>\nstruct Layout {\n",
         "template <int KC, uint32_t kRows = kStep>\nstruct Layout {\n"
         "  static constexpr uint32_t kChunk = kRows * 128;\n", 1),
        (None, "kStage = 2 * KC * kSmall;", "kStage = 2 * KC * kChunk;", 1),
        (None, "return first(s) + KC * kSmall;",
         "return first(s) + KC * kChunk;", 1),
        (DQ_KERNEL, "using L = Layout<KC>;",
         "constexpr int BK = 128;\n  using L = Layout<KC, BK>;", 1),
        (DQ_KERNEL, "kStep", "BK", 10),
        (DQ_KERNEL, "j0 + 63 > qw", "j0 + BK - 1 > qw", 1),
        (DQ_KERNEL, "* kSmall", "* L::kChunk", 5),
        (DQ_KERNEL, ", kSmall, 1024", ", L::kChunk, 1024", 1),
        (DQ_KERNEL, "da[4][4]", "da[BK / 16][4]", 1),
        (DQ_KERNEL, "sc[32], dp[32]", "sc[BK / 2], dp[BK / 2]", 1),
        (DQ_KERNEL, "wgmma_m64n64k16_ss(", "wgmma_m64n128k16_ss(", 2),
        (DQ_KERNEL, "i < 8; ++i) {\n      float p[4]",
         "i < BK / 8; ++i) {\n      float p[4]", 1),
        (DQ_KERNEL, "kk < 4; ++kk) hopper::fence_regs",
         "kk < BK / 16; ++kk) hopper::fence_regs", 2),
        (DQ_KERNEL, "kk < 4; ++kk)\n      rs_tb",
         "kk < BK / 16; ++kk)\n      rs_tb", 1),
        (LAUNCH, "{kBQ, kStep, kStep, kBQ}", "{kBQ, 128, 128, kBQ}", 1),
        (LAUNCH, "  const size_t smem = Layout<KC>::kBytes;\n",
         "  const size_t smem = Layout<KC>::kBytes;\n"
         "  const size_t smem_dq = Layout<KC, 128>::kBytes;\n", 1),
        (LAUNCH, "flash_bwd_dq_wgmma_kernel<D>,\n"
         "                               cudaFuncAttributeMaxDynamicShared"
         "MemorySize,\n                               static_cast<int>(smem)",
         "flash_bwd_dq_wgmma_kernel<D>,\n"
         "                               cudaFuncAttributeMaxDynamicShared"
         "MemorySize,\n"
         "                               static_cast<int>(smem_dq)", 1),
        (LAUNCH, "<<<grid_q, kThreads, smem, stream>>>",
         "<<<grid_q, kThreads, smem_dq, stream>>>", 1),
    ],
}


def variant_source(src: str, reps) -> str:
    """``src`` with each replacement made, every one asserted to occur
    exactly as often as it says within its region."""
    for region, old, new, count in reps:
        if region is None:
            lo, hi = 0, len(src)
        else:
            lo = src.index(region[0])
            hi = src.index(region[1], lo) + len(region[1])
        part = src[lo:hi]
        assert part.count(old) == count, (old, part.count(old), count)
        src = src[:lo] + part.replace(old, new) + src[hi:]
    return src


def ptxas_report(log: str) -> dict:
    """{kernel: "N registers, spills"} of the tensor-core kernels."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "Used" in line and "wgmma" in name:
            rows[re.sub(r"^_ZN\w*?tc\d+", "", name)[:40]] = \
                line.split(":")[-1].strip()
        elif name and "spill" in line and "wgmma" in name:
            rows[re.sub(r"^_ZN\w*?tc\d+", "", name)[:40] + " spills"] = \
                line.split(":")[-1].strip()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_kernel
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    entry = "flash_attention_bwd_launch"
    fns = {"base": _build.library("flash_attention_bwd")}
    reports = {"base": ptxas_report(_build.build_log["flash_attention_bwd"])}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for tag, reps in VARIANTS.items():
        cu = OUT_DIR / f"{tag}.cu"
        cu.write_text(variant_source(src, reps))
        procs[tag] = (cu, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(OUT_DIR / f"lib{tag}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for tag, (cu, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag}: nvcc exit {proc.returncode}\n{err}")
        reports[tag] = ptxas_report(out + err)
        fn = getattr(ctypes.CDLL(str(OUT_DIR / f"lib{tag}.so")), entry)
        fn.argtypes = _build._ENTRY["flash_attention_bwd"][1]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    for tag, rep in reports.items():
        print(json.dumps({"ptxas": tag, **rep}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(b, sq, skv, h, kv, hd, hd_v, causal):
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev)
        k = torch.randn((b, skv, kv, hd), generator=gen, device=dev)
        v = torch.randn((b, skv, kv, hd_v), generator=gen, device=dev)
        do = torch.randn((b, sq, h, hd_v), generator=gen, device=dev)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          return_lse=True)
        return q, k, v, out, lse, do

    checks = [(case, inputs(*case)) for case in CASES]
    b, s, h, hd = MAIN
    main_in = inputs(b, s, s, h, h, hd, hd, True)
    errors, times = {}, {tag: [] for tag in fns}

    def use(tag):
        _build._libs[entry] = fns[tag]

    for tag in fns:
        use(tag)
        worst = 0.0
        for case, (q, k, v, out, lse, do) in checks:
            got = flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                             causal=case[-1])
            want = ref.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                     case[-1])
            for g, w in zip(got, want):
                worst = max(worst, float((g.float() - w.float()).abs().max()
                                         / w.float().abs().max()))
        errors[tag] = worst
        print(json.dumps({"check": tag, "max_rel_err": worst, "tol": TOL}),
              flush=True)
        if worst > TOL:
            raise AssertionError(f"{tag} disagrees with the plain version")

    def time_main(tag, calls=20, reps=3):
        use(tag)
        for _ in range(3):
            flash_attention_bwd_kernel(*main_in, causal=True)
        torch.cuda.synchronize()
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                flash_attention_bwd_kernel(*main_in, causal=True)
            e1.record()
            torch.cuda.synchronize()
            times[tag].append(e0.elapsed_time(e1) / calls)
        print(json.dumps({"timed": tag, "ms": times[tag][-reps:]}),
              flush=True)

    order = list(fns) + list(fns)[::-1]
    for tag in order:
        time_main(tag)
    use("base")
    result = {"card": card, "shape": {"B": b, "S": s, "H": h, "hd": hd,
                                      "causal": True},
              "order": order, "best_ms": {t: min(v) for t, v in times.items()},
              "ms": times, "max_rel_err": errors, "ptxas": reports}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
