"""Error and alternated timing of variants of the float32 flash forward.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with a
few text replacements, built beside the repo's own library with the same
nvcc flags and swapped in for it as the wrapper's launch function.  Every
build is held against a float64 attention on the card (max and rms error
of max |float64|, beside the plain float32 version's,
``kernels.ref.mha_reference``), at causal 192/128 (MLA's widths), 128,
96 under GQA and full 64, then timed by CUDA events at MLA's, qwen2-7b's
and whisper's encoder prefill shapes in the order base, variants,
variants reversed, base, so that a drift of the card's clock falls on
both sides.

    python3 tools/flash_fwd_variants.py          # needs one H100 and nvcc

Prints ptxas's registers and spills of the 3xTF32 kernel in every build,
one JSON line per error check and per timing, and a last JSON line with
each build's errors and times.

The variants of how S = Q K^T is summed (the base: the hi.hi products of
each 32-wide chunk of hd in one of NB accumulators, the lo.hi and hi.lo
products in one more, ``Cfg``):
  * ``one_accumulator``: every product of S in one accumulator;
  * ``nb1``: NB = 1 at every width;
  * ``nb_chunks``: NB = the number of chunks (one accumulator a chunk).
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT_DIR = ROOT / "build" / "flash_fwd_variants"
CHECKS = [  # B, S, H, KV, hd, hd_v, causal
    (1, 1024, 4, 4, 192, 128, True),
    (1, 2048, 4, 4, 128, 128, True),
    (1, 1024, 8, 2, 96, 96, True),
    (1, 1024, 4, 4, 64, 64, False),
]
TIMED = {"mla": (1, 4096, 16, 16, 192, 128, True),
         "qwen2_7b": (1, 4096, 28, 4, 128, 128, True),
         "whisper_encoder": (1, 4096, 12, 12, 64, 64, False)}
TOL = 1e-4

CFG = "struct Cfg<{}> {{ static constexpr int WG = {}, BKV = {}, KS = 2, VS = {}, NB = {}; }};"
# (old, new, how many times old occurs)
VARIANTS = {
    "one_accumulator": [
        ("        ss<BKV>(big[c * NB / QC], desc_sw128(qa, 16, 1024),\n"
         "                desc_sw128(kb, 16, 1024), !starts);",
         "        ss<BKV>(sc, desc_sw128(qa, 16, 1024),\n"
         "                desc_sw128(kb, 16, 1024), 1);", 1),
    ],
    "nb1": [
        (CFG.format(96, 2, 32, 2, 2), CFG.format(96, 2, 32, 2, 1), 1),
        (CFG.format(192, 1, 32, 1, 3), CFG.format(192, 1, 32, 1, 1), 1),
    ],
    "nb_chunks": [
        (CFG.format(64, 2, 64, 2, 1), CFG.format(64, 2, 64, 2, 2), 1),
        (CFG.format(96, 2, 32, 2, 2), CFG.format(96, 2, 32, 2, 3), 1),
        (CFG.format(128, 2, 32, 1, 1), CFG.format(128, 2, 32, 1, 4), 1),
        (CFG.format(192, 1, 32, 1, 3), CFG.format(192, 1, 32, 1, 6), 1),
    ],
}


def variant_source(src: str, reps) -> str:
    """``src`` with each replacement made, every one asserted to occur
    exactly as often as it says."""
    for old, new, count in reps:
        assert src.count(old) == count, (old, src.count(old), count)
        src = src.replace(old, new)
    return src


def ptxas_report(log: str) -> dict:
    """{padded width: "N registers, spills"} of the 3xTF32 kernel."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "3xtf32" in name and ("Used" in line or
                                            "spill" in line):
            width = re.search(r"ILi(\d+)E", name).group(1)
            rows[width] = (rows.get(width, "") + " " +
                           line.split(":")[-1].strip()).strip()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    entry = "flash_attention_launch"
    fns = {"base": _build.library("flash_attention")}
    reports = {"base": ptxas_report(_build.build_log["flash_attention"])}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for tag, reps in VARIANTS.items():
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
        fn.argtypes = _build._ENTRY["flash_attention"][1]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    for tag, rep in reports.items():
        print(json.dumps({"ptxas": tag, **rep}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(b, s, h, kv, hd, hd_v, causal):
        return (torch.randn((b, s, h, hd), generator=gen, device=dev),
                torch.randn((b, s, kv, hd), generator=gen, device=dev),
                torch.randn((b, s, kv, hd_v), generator=gen, device=dev))

    def f64(q, k, v, causal):
        b, s, h, hd = q.shape
        kv = k.shape[2]
        qg = q.double().reshape(b, s, kv, h // kv, hd) / hd ** 0.5
        sc = torch.einsum("bqkgd,bckd->bqkgc", qg, k.double())
        if causal:
            keep = torch.arange(s, device=dev)[None] <= \
                torch.arange(s, device=dev)[:, None]
            sc = sc.masked_fill(~keep[None, :, None, None, :], -1e300)
        return torch.einsum("bqkgc,bckd->bqkgd", torch.softmax(sc, -1),
                            v.double()).reshape(b, s, h, v.shape[3])

    def use(tag):
        _build._libs[entry] = fns[tag]

    def err(got, want) -> tuple:
        top = float(want.abs().max())
        d = got.double() - want
        return (float(d.abs().max()) / top,
                float(d.square().mean().sqrt()) / top)

    errors = {tag: [] for tag in ["plain"] + list(fns)}
    for case in CHECKS:
        q, k, v = inputs(*case)
        want = f64(q, k, v, case[-1])
        row = {"check": case,
               "plain": err(ref.mha_reference(q, k, v, causal=case[-1]),
                            want)}
        for tag in fns:
            use(tag)
            row[tag] = err(flash_attention_kernel(q, k, v, causal=case[-1]),
                           want)
        for tag in errors:
            errors[tag].append(row[tag])
        print(json.dumps({**row, "as": "(max, rms) of max |float64|"}),
              flush=True)
        if any(row[tag][0] > TOL for tag in fns):
            raise AssertionError(f"a build is off by more than {TOL}: {row}")

    times = {name: {tag: [] for tag in fns} for name in TIMED}
    order = list(fns) + list(fns)[::-1]
    for name, case in TIMED.items():
        q, k, v = inputs(*case)
        for tag in order:
            use(tag)
            for _ in range(3):
                flash_attention_kernel(q, k, v, causal=case[-1])
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                flash_attention_kernel(q, k, v, causal=case[-1])
            e1.record()
            torch.cuda.synchronize()
            times[name][tag].append(e0.elapsed_time(e1) / 20)
        print(json.dumps({"timed": name, "ms": times[name]}), flush=True)
    use("base")
    print(json.dumps({"card": card, "order": order, "errors": errors,
                      "ms": times, "ptxas": reports}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
