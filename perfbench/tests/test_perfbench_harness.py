"""The harness finds configurations, traffic mixes and metrics by name and
drives a whole run on the CPU, at a test-only size
(``tests/configs/tiny*.json``, ``tests/benchmark.json``)."""
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, system, traffic
from perfbench.operators import generate
from perfbench.reference import DeviceCSR

HERE = Path(__file__).resolve().parent
SEED = 2**31 + 977


@pytest.fixture
def dirs(tmp_path):
    return harness.Dirs(bench=HERE / "benchmark.json", configs=HERE / "configs",
                        cache=tmp_path / "operators")


def run(cell, trace, dirs, **kw):
    return harness.run(cell, SEED, 1.0, trace, device=torch.device("cpu"),
                       t0=time.time(), dirs=dirs, **kw)


def test_lookup_by_name(dirs):
    bench, cell, cfg, mix = harness.load_cell("ksp.tiny", dirs)
    assert cell["config"] == "tiny" and cfg["name"] == "tiny"
    assert mix["stop"]["rtol"] == 1e-5 and mix["generator"] == "closed_loop"
    assert traffic.generator(mix).__name__ == "perfbench.traffic.closed_loop"
    names = [m["name"] for m in harness.metric_entries(bench, "ksp.tiny", False)]
    assert names == ["solve_s", "peak_mem_gib", "setup_s"]
    names = [m["name"] for m in
             harness.metric_entries(bench, "cgsets.tiny-hpcg", True)]
    assert names == ["plan_build_s", "cg_iter_ms", "launches_per_iter",
                     "spmv_roofline", "device_idle_pct"]
    with pytest.raises(KeyError):
        harness.load_cell("ksp.none", dirs)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell,judged", [("ksp.tiny", "true_rel_residual"),
                                         ("cgsets.tiny-hpcg",
                                          "iterate_rel_error")])
def test_one_card_run_on_the_cpu(cell, judged, trace, dirs):
    out, checks = run(cell, trace, dirs)
    assert out["correct"], checks
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert list(out["checks"])[0] == judged
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert checks["checked_solves"]["value"] == min(out["attempted"], 8)
    m = out["metrics"]
    if trace:
        # the CPU has no card: the device's readers find nothing to read
        want = {"plan_build_s", "cg_iter_ms"} | (
            {"cg_iters"} if cell == "ksp.tiny" else set())
        assert set(m) == want
        assert out["breakdown"]["device_ops"] == []
    else:
        assert set(m) == {"solve_s", "setup_s"}    # no peak on the CPU
        assert m["setup_s"]["value"] > 0 and m["solve_s"]["value"] > 0
    assert all(math.isfinite(v["value"]) for v in m.values())


def test_hpcg_sets_run_fifty_iterations(dirs):
    out, _ = run("cgsets.tiny-hpcg", True, dirs)
    assert out["metrics"]["cg_iter_ms"]["value"] > 0
    _, _, cfg, mix = harness.load_cell("cgsets.tiny-hpcg", dirs)
    A = DeviceCSR.of(generate(cfg["operator"]), "cpu")
    load = traffic.generator(mix).Traffic(mix, A, SEED)
    assert (load.tol, load.maxiter) == (0.0, 50)
    assert load.met_stop(50, 1e-3) and not load.met_stop(49, 1e-3)
    # b = A 1: zero inside the grid, 26 less the neighbours on its faces
    b = load.rhs(0).view(16, 16, 16)
    assert (b[1:-1, 1:-1, 1:-1] == 0).all() and b[0, 0, 0] == 19


def test_same_seed_same_traffic():
    op = generate({"generator": "fluidity_graded", "n_surface": 100,
                   "layers": 4})
    A = DeviceCSR.of(op, "cpu")
    mix = traffic.load("ksp")
    gen = traffic.generator(mix)
    a, b, c = (gen.Traffic(mix, A, s) for s in (SEED, SEED, SEED + 1))
    assert a.order == b.order and a.order != c.order
    assert sorted(a.order) == sorted(c.order) == list(range(mix["systems"]))
    # every seed solves the same systems, in its own order
    assert torch.equal(a.b, c.b)
    assert torch.equal(a.rhs(3), b.rhs(3))
    assert not torch.equal(a.b[0], a.b[1])
    r1, r2 = gen.Reservoir(8, SEED), gen.Reservoir(8, SEED)
    for i in range(50):
        assert r1.offer(i) == r2.offer(i)
    assert len(r1.kept()) == 8


def test_operator_cache_loads_what_it_made(tmp_path):
    spec = {"generator": "fluidity_graded", "n_surface": 200, "layers": 6}
    made = generate(spec, cache=tmp_path)
    (path,) = tmp_path.iterdir()
    assert path.name.startswith("fluidity_graded-")
    loaded = generate(spec, cache=tmp_path)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(made, k), getattr(loaded, k))
        assert getattr(loaded, k).dtype == getattr(made, k).dtype
    generate(dict(spec, layers=7), cache=tmp_path)
    assert len(list(tmp_path.iterdir())) == 2


@pytest.fixture
def no_jax_in_children(monkeypatch):
    """Subprocesses start without the test suite's JAX shim on their
    path."""
    keep = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and "_jaxcompat" not in p]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(harness.ROOT / "src"), *keep]))


def test_forbidden_modules_compare_whole_names():
    assert system.forbidden_modules(["repro_torch", "repro_torch.core",
                                     "jaxtyping", "numpy"]) == []
    assert system.forbidden_modules(["repro.core", "jax", "jaxlib.xla",
                                     "flax"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def test_without_a_card_no_result(no_jax_in_children):
    """Exit 2 and no result line when the cell's cards are not there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(harness.ROOT / "perfbench" / "run.py"),
                        "--workload", "ksp.fluidity-graded-6.7m", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=harness.ROOT)
    assert p.returncode == 2 and p.stdout == ""
