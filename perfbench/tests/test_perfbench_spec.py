"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, the files every entry names, and the arrows from per-layer to
end-to-end metrics.  CPU only; run with
``python -m pytest -q perfbench/tests``."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(text(w) for w in cmd)
    assert cmd == ["python3", "perfbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= len(names) <= {"configs": 24, "workloads": 24,
                               "end_to_end": 16, "per_layer": 128}[group]


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text(c["source"]) and text(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("perfbench/") and PATH.match(c["file"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (ROOT / "perfbench" / "reference" /
                f"{cfg['reference']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used, f"{c['name']} is used by no cell"


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and text(w["why"])
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "perfbench" / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" /
                f"{traffic['driver']}.py").is_file()
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and text(m["layer"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # every cell that reports this metric reports the one it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    for w in cells:
        reports = [m for m in BENCH["end_to_end"]
                   if w in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "perfbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel
