"""BENCHMARK.json and the result line keep the benchmark's contract: the
keys, names, units and limits a checker reads, and a budget that holds with
the full 24 cells."""

from __future__ import annotations

import json
import re
import types

import pytest

from benchmark import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# Sizes that name a width: never reduced.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|experts_per_token)")


@pytest.fixture(scope="module")
def bench() -> dict:
    return H.load_json(H.ROOT / "BENCHMARK.json")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    named = [w for w in bench["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in bench["paths"]) for w in named)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_budget_holds_with_24_cells(bench):
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"]) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        body = H.load_json(H.ROOT / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (H.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        layers.setdefault(m["layer"], set()).add(m["name"])
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert cell in cells and cell in moved.get("workloads", cells)
        assert (H.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = H.load_cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def _fake_run(traced: bool):
    cell = H.Cell("c", {"chips": 1}, {}, {}, [{"name": "setup_s", "unit": "s"}, {"name": "x_per_s", "unit": "x/s"}],
                  [{"name": "device.idle_pct.root", "unit": "%"}])
    ctx = H.Ctx(types.SimpleNamespace(seed=1, seconds=1.0, trace=int(traced)), cell, 0.0)
    ctx.setup_s = 12.5
    ctx.memory_peak_bytes = 1 << 30
    if traced:
        ctx.trace = H.Trace((0, 10**9), [("k", 0, 10**8), ("k", 5 * 10**7, 10**8)], 0.15, 1.0, [("segment", 0, 10**9)])
    out = H.Outcome(10, 0, {"x_per_s": 3.25}, [H.Check("differing", 0, 0)], {})
    return H.result_line(cell, ctx, out, {"platform": "gpu", "kind": "card", "count": 1})


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    line = _fake_run(traced)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert line["correct"] is True and line["checks"] == {"differing": {"value": 0, "limit": 0}}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and isinstance(m["value"], float)
    if traced:
        assert line["device"]["busy_s"] == 0.15 and line["device"]["window_s"] == 1.0
        assert line["metrics"]["device.idle_pct.root"]["value"] == pytest.approx(85.0)
        assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
        assert line["breakdown"]["idle_gaps"][0][0] == "segment"
    else:
        assert set(line["metrics"]) == {"setup_s", "x_per_s"}


def test_a_failed_check_is_not_correct():
    cell = H.Cell("c", {"chips": 1}, {}, {}, [], [])
    ctx = H.Ctx(types.SimpleNamespace(seed=1, seconds=1.0, trace=0), cell, 0.0)
    out = H.Outcome(1, 0, {}, [H.Check("differing", 1, 0)], {})
    assert H.result_line(cell, ctx, out, {})["correct"] is False
