"""Error and alternated timing of variants of the flash attention backward.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with a few text replacements, built beside the repo's own library with the
same nvcc flags and swapped in for it as the wrapper's launch function.
Every build is first held against the plain version
(``kernels.ref.flash_attention_bwd_reference``) on a few small cases in
both dtypes (within 1e-4 of max |plain| in float32, 2e-2 in bfloat16).
Then each float32 build is held against a float64 attention backward on
the card (the plain version in float64: max and rms error of dq, dk and
dv together, relative to max |float64|, beside the plain float32
version's) at phi3-mini's training shape (1 x 4096, 32 heads of 96,
causal) and at MLA's (1 x 4096, 16 heads of 192/128, causal), and every
build is timed there by CUDA events in its dtype, in the order base,
variants, variants reversed, base, so that a drift of the card's clock
falls on both sides.

    python3 tools/flash_bwd_variants.py          # needs one H100 and nvcc

Prints ptxas's registers and spills of every build's tensor-core kernels,
one JSON line per check, per error and per timing, and a last JSON line
with each build's errors and times.

The variants:
  * ``stages3`` (bfloat16): a ring of three stages in place of two (both
    kernels);
  * ``nb1`` (float32): the hi.hi products of S and dP in one accumulator
    a tile (NB = 1 at every width) in place of NB = 2 at hd 96 and 3 at
    192;
  * ``one_accumulator`` (float32): each pass's output (dv, dk or dq) is
    summed by wgmma in its accumulators over the whole sweep, in place of
    a fresh accumulator a tile added into float32 registers;
  * ``split_dkdv`` (float32): dv and dk in passes of their own at every
    width, in place of one pass with a warpgroup each up to hd 96;
  * ``dq_one_warpgroup`` (float32): the dq pass with one consumer
    warpgroup at every width, in place of two on alternate key tiles up
    to hd 96.
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
TIMED = {"phi3": (1, 4096, 4096, 32, 32, 96, 96, True),
         "mla": (1, 4096, 4096, 16, 16, 192, 128, True)}
CASES = [  # B, Sq, Skv, H, KV, hd, hd_v, causal
    (1, 200, 200, 7, 1, 96, 96, True),
    (2, 130, 65, 14, 2, 96, 96, True),
    (1, 128, 600, 4, 4, 64, 64, False),
    (1, 127, 129, 4, 2, 128, 64, True),
    (1, 150, 150, 8, 2, 192, 128, True),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (old, new, how many times old occurs), and the dtype each variant changes
VARIANTS = {
    "stages3": ("bfloat16", [
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;", 1),
    ]),
    "nb1": ("float32", [
        ("static constexpr int NB = HDP == 192 ? 3 : HDP == 96 ? 2 : 1;",
         "static constexpr int NB = 1;", 1),
    ]),
    "one_accumulator": ("float32", [
        ("float out[W / 2], part[NP][NC / 2];",
         "float out[W / 2], part[NCH][NC / 2];", 1),
        ("for (int j = 0; j < NP; ++j) part[j][i] = 0.f;",
         "for (int j = 0; j < NCH; ++j) part[j][i] = 0.f;", 1),
        ("part[c % NP]", "part[c]", 5),
        ("rs<NC>(part[c], fl[i], desc_t<T>(eb), i != 0);",
         "rs<NC>(part[c], fl[i], desc_t<T>(eb), 1);", 1),
        ("hopper::fence_regs(part[(c - 1) % NP]);",
         "hopper::fence_regs(part[c - 1]);", 1),
        ("out[NC / 2 * (c - 1) + j] += part[(c - 1) % NP][j];", "(void)j;", 1),
        ("hopper::fence_regs(part[(NCH - 1) % NP]);",
         "hopper::fence_regs(part[NCH - 1]);", 1),
        ("out[NC / 2 * (NCH - 1) + j] += part[(NCH - 1) % NP][j];",
         "(void)j;", 1),
        ("  if constexpr (C::ALT) {\n",
         "#pragma unroll\n  for (int c = 0; c < NCH; ++c)\n"
         "#pragma unroll\n    for (int j = 0; j < NC / 2; ++j)\n"
         "      out[NC / 2 * c + j] = part[c][j];\n"
         "  if constexpr (C::ALT) {\n", 1),
    ]),
    "split_dkdv": ("float32", [
        ("constexpr bool kFused = HDP <= 96;", "constexpr bool kFused = false;",
         1),
    ]),
    "dq_one_warpgroup": ("float32", [
        ("static constexpr bool ALT = KIND == kDQ && HDP <= 96;",
         "static constexpr bool ALT = false;", 1),
    ]),
}


def variant_source(src: str, reps) -> str:
    """``src`` with each replacement made, every one asserted to occur
    exactly as often as it says."""
    for old, new, count in reps:
        assert src.count(old) == count, (old, src.count(old), count)
        src = src.replace(old, new)
    return src


def ptxas_report(log: str) -> dict:
    """{kernel: "N registers, spills"} of the tensor-core kernels."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("wgmma" in name or "3xtf32" in name) and \
                ("Used" in line or "spill" in line):
            short = re.sub(r"^_ZN\w*?(?:tc|f32)\d+", "", name)[:44]
            rows[short] = (rows.get(short, "") + " " +
                           line.split(":")[-1].strip()).strip()
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
    torch.backends.cuda.matmul.allow_tf32 = False
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
    for tag, (_, reps) in VARIANTS.items():
        cu = OUT_DIR / f"{tag}.cu"
        cu.write_text(variant_source(src, reps))
        procs[tag] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(OUT_DIR / f"lib{tag}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for tag, proc in procs.items():
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

    def inputs(dt, b, sq, skv, h, kv, hd, hd_v, causal):
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(dt)
                       for sh in ((b, sq, h, hd), (b, skv, kv, hd),
                                  (b, skv, kv, hd_v), (b, sq, h, hd_v)))
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          return_lse=True)
        return q, k, v, out, lse, do

    def use(tag):
        _build._libs[entry] = fns[tag]

    def builds(dname):
        return ["base"] + [t for t, (d, _) in VARIANTS.items()
                           if d == dname]

    for case in CASES:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt)[6:]
            q, k, v, out, lse, do = inputs(dt, *case)
            want = ref.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                     case[-1])
            row = {"check": case, "dtype": dname}
            for tag in builds(dname):
                use(tag)
                got = flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                                 causal=case[-1])
                row[tag] = max(float((g.float() - w.float()).abs().max() /
                                     w.float().abs().max())
                               for g, w in zip(got, want))
            print(json.dumps(row), flush=True)
            if any(row[tag] > TOL[dname] for tag in builds(dname)):
                raise AssertionError(f"a build disagrees with the plain "
                                     f"version: {row}")

    def err(got, want) -> tuple:
        top = max(float(w.abs().max()) for w in want)
        mx = max(float((g.double() - w).abs().max()) for g, w in
                 zip(got, want))
        sq = sum(float((g.double() - w).square().sum()) for g, w in
                 zip(got, want))
        n = sum(w.numel() for w in want)
        return mx / top, (sq / n) ** 0.5 / top

    errors = {}
    for name, case in TIMED.items():
        q, k, v, out, lse, do = inputs(torch.float32, *case)
        want = ref.flash_attention_bwd_reference(
            q, k, v, out, lse, do, case[-1], acc=torch.float64)
        row = {"plain": err(ref.flash_attention_bwd_reference(
            q, k, v, out, lse, do, case[-1]), want)}
        for tag in builds("float32"):
            use(tag)
            row[tag] = err(flash_attention_bwd_kernel(
                q, k, v, out, lse, do, causal=case[-1]), want)
        errors[name] = row
        print(json.dumps({"error": name, **row,
                          "as": "(max, rms) of max |float64|"}), flush=True)
        del want
        torch.cuda.empty_cache()

    times = {}
    for name, case in TIMED.items():
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt)[6:]
            args = inputs(dt, *case)
            order = builds(dname) + builds(dname)[::-1]
            key = f"{name}_{dname}"
            times[key] = {tag: [] for tag in builds(dname)}
            for tag in order:
                use(tag)
                for _ in range(2):
                    flash_attention_bwd_kernel(*args, causal=case[-1])
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(10):
                    flash_attention_bwd_kernel(*args, causal=case[-1])
                e1.record()
                torch.cuda.synchronize()
                times[key][tag].append(e0.elapsed_time(e1) / 10)
            print(json.dumps({"timed": key, "order": order,
                              "ms": times[key]}), flush=True)
            del args
            torch.cuda.empty_cache()
    use("base")
    print(json.dumps({"card": card, "errors": errors, "ms": times,
                      "ptxas": reports}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
