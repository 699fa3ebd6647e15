"""The port's test CLIs against the JAX reference's, on the CPU:
``analyze``, ``square_golden`` and ``examples/quickstart_torch.py``.

The reference CLIs run as subprocesses (they need their own XLA device
count); the port's run in-process with ``--device cpu``.  ``analyze``'s
JSON reports are held equal after removing, from the reference's, the
violations that differ by design (``tests/test_torch_analyze.py``'s
docstring, ROADMAP C): the ``jit`` wrappers jax 0.9's traces carry and
the reference SELL matvec's scatter-add.
"""
import json
import os
import subprocess
import sys

import pytest

from conftest import run_subprocess
from repro_torch.testing import analyze, square_golden

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "golden_square_hashes.json")


def _by_design(v: dict) -> bool:
    return ((v["code"] == "J_PAYLOAD_UNKNOWN_OP" and "'jit'" in v["message"])
            or (v["code"] == "J_SCATTER_UNORDERED"
                and v["context"].get("format") == "sell"))


def _summary(violations) -> dict:
    out = {}
    for v in violations:
        out[v["code"]] = out.get(v["code"], 0) + 1
    return dict(sorted(out.items()))


def _reference_analyze(tmp_path, *flags):
    path = tmp_path / "ref.json"
    res = run_subprocess(["-m", "repro.testing.analyze", "--json",
                          str(path), *flags])
    return res.returncode, json.loads(path.read_text())


@pytest.mark.parametrize("flags", [(), ("--include-faulty",)],
                         ids=["clean", "faulty"])
def test_analyze_report_equals_reference(flags, tmp_path, capsys):
    path = tmp_path / "port.json"
    rc = analyze.main(["--device", "cpu", "--json", str(path), *flags])
    port = json.loads(path.read_text())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["checks"] == port["checks"]
    ref_rc, ref = _reference_analyze(tmp_path, *flags)
    kept = [v for v in ref["violations"] if not _by_design(v)]
    assert (rc, ref_rc) == ((1, 1) if flags else (0, 0))
    assert port["checks"] == ref["checks"] == (670 if flags else 598)
    assert port["errors"] == ref["errors"]
    assert port["warnings"] == sum(v["severity"] == "warning" for v in kept)
    assert port["summary"] == _summary(kept)
    assert [(v["code"], v["context"]) for v in port["violations"]] == \
        [(v["code"], v["context"]) for v in kept]
    assert port["sweep"] == {**ref["sweep"], "device": "cpu"}
    if flags:
        assert "J_PAYLOAD_TRANSFORM" in port["summary"]


def test_analyze_hlo_and_strict(capsys):
    assert analyze.main(["--device", "cpu", "--hlo", "--strict",
                         "--formats", "sell", "--wire-dtypes", "f32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["warnings"] == 0 and out["sweep"]["hlo"]


def test_square_golden_check_matches_every_plan_hash(capsys):
    assert square_golden.main(["--device", "cpu", "--check", FIXTURE]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "square_golden: 8 entries, 0 failures, 16 skipped"
    skips = [ln for ln in lines if ln.startswith("SKIP ")]
    assert len(skips) == 16 and all("jax_version" in s for s in skips)
    assert not any(ln.startswith("FAIL") for ln in lines)


def test_square_golden_fails_on_an_altered_plan_hash(tmp_path, capsys):
    with open(FIXTURE) as f:
        doc = json.load(f)
    h = doc["entries"]["sell/ring"]["plan"]["x_gather"]
    doc["entries"]["sell/ring"]["plan"]["x_gather"] = h[::-1]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert square_golden.main(["--device", "cpu", "--check", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "FAIL sell/ring: plan array 'x_gather' hash drift" in out
    assert "1 failures" in out


def test_square_golden_write_then_check_compares_outputs(tmp_path, capsys):
    path = tmp_path / "port.json"
    assert square_golden.main(["--device", "cpu", "--write",
                               str(path)]) == 0
    doc = json.loads(path.read_text())
    assert doc["device"] == "cpu" and "jax_version" not in doc
    with open(FIXTURE) as f:
        ref = json.load(f)
    for key, entry in ref["entries"].items():
        assert doc["entries"][key]["plan"] == entry["plan"]
    assert square_golden.main(["--device", "cpu", "--check",
                               str(path)]) == 0
    assert "0 failures, 0 skipped" in capsys.readouterr().out
    # the JAX package's fixture is never overwritten
    with pytest.raises(SystemExit):
        square_golden.main(["--device", "cpu", "--write", FIXTURE])


def test_quickstart_runs_clean():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable,
                          os.path.join(REPO, "examples",
                                       "quickstart_torch.py"),
                          "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("matrix: 3200 DoF")
    errs = [float(ln.split()[-1]) for ln in lines if "SpMV max err" in ln]
    assert len(errs) == 3 and max(errs) < 1e-4
    assert [ln.split(":")[0].split("=")[1].strip() for ln in lines
            if ln.startswith("solver=")] == ["cg", "pipelined_cg",
                                             "chebyshev"]
