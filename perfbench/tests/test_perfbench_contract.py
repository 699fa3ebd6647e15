"""BENCHMARK.json against the rules every cell, metric and configuration
keeps: names, lengths, references by name, the files each name finds."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_and_names():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = []
    for group, keys in (("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        for e in BENCH[group]:
            assert set(e) <= KEYS[keys], e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert text(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    assert len(names) == len(set(names))


def test_configs_and_cells_refer_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        path = ROOT / c["file"]
        assert c["file"].startswith("perfbench/configs/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] or c["source"] in cfg["source"]
        assert cfg["chips"] in (1, 4)
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        mix = json.loads((ROOT / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert mix["name"] == w["traffic"] and text(mix["source"])
        assert (ROOT / "perfbench" / "traffic"
                / f"{mix['generator']}.py").is_file()
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["chips"] == w["chips"]
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and text(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in cells:
        got = harness.metric_entries(BENCH, cell, False)
        names = {m["name"] for m in got}
        assert "setup_s" in names and len(names) >= 2, cell
        layer = harness.metric_entries(BENCH, cell, True)
        assert layer, cell
        for m in layer:          # each reports the metric it moves
            assert m["moves"] in names, (cell, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_command_stays_inside_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(text(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert w.startswith("perfbench/") and (ROOT / w).exists()


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        (ROOT / "perfbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Every import's top-level name, compared whole: ``repro_torch`` is the
    port, ``repro`` the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top not in ("jax", "jaxlib", "flax", "repro"), (path, top)
    # names handed to importlib are perfbench's own
    for m in re.findall(r"import_module\(f?[\"']([^\"'{]+)", (ROOT / path).read_text()):
        assert m.split(".")[0] == "perfbench", (path, m)
