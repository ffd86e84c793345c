"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and entries only: the harness finds each by name."""

from __future__ import annotations

import json
import shutil

from benchmark import harness as H


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(H.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = H.load_json(H.ROOT / "BENCHMARK.json")
    (root / "benchmark" / "configs" / "tiny_deneb.json").write_text(json.dumps({"name": "tiny_deneb", "validators": 64}))
    (root / "benchmark" / "traffic" / "echo.json").write_text(json.dumps({"driver": "echo", "count": 3}))
    (root / "benchmark" / "drivers" / "echo.py").write_text(
        "from benchmark.harness import Outcome\n"
        "def run(ctx):\n"
        "    return Outcome(3, 0, {'echo_per_s': 1.0}, [], {'count': ctx.cell.traffic['count']})\n"
    )
    (root / "benchmark" / "metrics" / "echo.count.py").write_text("def read(run):\n    return float(run.work['count'])\n")
    bench["configs"].append({"name": "tiny_deneb", "source": "https://example.org/tiny", "file": "benchmark/configs/tiny_deneb.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.echo", "config": "tiny_deneb", "traffic": "echo", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["tiny.echo"]})
    bench["per_layer"].append({"name": "echo.count", "unit": "n", "better": "higher", "source": "program_counter",
                               "layer": "Echo", "moves": "echo_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = H.load_cell("tiny.echo", root=root)
    assert cell.config["validators"] == 64 and cell.traffic["count"] == 3
    assert sorted(m["name"] for m in cell.end_to_end) == ["echo_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["echo.count"]
    out = H.driver_of(cell, root).run(type("Ctx", (), {"cell": cell})())
    assert H.metric_reader("echo.count", root).read(type("Run", (), {"work": out.work})()) == 3.0
    # the cells already there do not see the new metric
    assert "echo.count" not in [m["name"] for m in H.load_cell("electra_1m.state_root", root=root).per_layer]


def test_a_missing_name_is_refused(tmp_path):
    bench = H.load_json(H.ROOT / "BENCHMARK.json")
    try:
        H.load_cell("no.such_cell", bench)
    except H.BenchError as e:
        assert "no.such_cell" in str(e)
    else:
        raise AssertionError("an unknown cell was accepted")
