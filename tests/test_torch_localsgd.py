"""Compression, local SGD and elastic restore (``runtime/compression.py``,
``runtime/localsgd.py``, ``testing/{localsgd,elastic}_check.py``) against
the reference, on the CPU.

* ``compress_topk``'s values and mask equal the reference's bit for bit,
  ties included (a tie at the threshold keeps every tied value in both),
  and the reference's own cases (``tests/test_runtime.py``) hold;
* ``ef_compress_tree`` over 50 rounds, each codec, gives the reference's
  compressed values and residuals within 1e-6·max|g|;
* ``pod_sync`` on one pod equals the reference's on a one-device ``pod``
  mesh bit for bit; ``make_pod_sync`` is ``None`` without a ``pod`` axis;
* ``localsgd_check`` on 2 gloo ranks and ``elastic_check`` on 4 then 2
  gloo ranks print ``OK``;
* ``examples/serve_lm_torch.py --device cpu`` (the counterpart of
  ``examples/serve_lm.py``) serves its 8 requests.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.compression import compress_topk, ef_compress_tree
from repro_torch.runtime.localsgd import make_pod_sync, pod_sync

jnp = pytest.importorskip("jax.numpy")
ref_c = pytest.importorskip("repro.runtime.compression")

CODECS = ("int8", "topk", "none")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


TOPK_CASES = {
    "normal": (np.random.default_rng(0).normal(size=(64, 48)), 0.05),
    "ties": (np.array([3.0, -3.0, 1.0, 3.0, -0.5, 2.0, -3.0, 0.0]), 0.25),
    "all_equal": (np.full((16,), 0.5), 0.1),
    "tiny_frac": (np.random.default_rng(1).normal(size=(7, 5)), 1e-4),
    "reference_case": (np.array([0.1, -5.0, 0.2, 3.0, -0.05]), 0.4),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_compress_topk_matches_reference(case):
    x, frac = TOPK_CASES[case]
    x = x.astype(np.float32)
    got, mask = compress_topk(torch.from_numpy(x), frac)
    want, wmask = ref_c.compress_topk(jnp.asarray(x), frac)
    assert np.array_equal(mask.numpy(), np.asarray(wmask))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    if case == "reference_case":       # tests/test_runtime.py's
        np.testing.assert_allclose(got.numpy(), [0, -5.0, 0, 3.0, 0])
    if case == "ties":                 # k = 2, three values tie at 3
        assert int(mask.sum()) == 4


@pytest.mark.parametrize("codec", CODECS)
def test_ef_compress_tree_matches_reference_over_rounds(codec):
    rng = np.random.default_rng(3)
    shapes = {"a": (32,), "b": {"c": (8, 12), "d": (5,)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32)
                for k, v in tree.items()}

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                np.zeros(v, np.float32) for k, v in tree.items()}

    def leaves(tree):
        for k in sorted(tree):
            v = tree[k]
            yield from leaves(v) if isinstance(v, dict) else (v,)

    def to_t(tree):
        return {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in tree.items()}

    def to_j(tree):
        return {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in tree.items()}

    res_t, res_j = to_t(zeros(shapes)), to_j(zeros(shapes))
    worst = 0.0
    for _ in range(50):
        g = draw(shapes)
        top = max(float(np.abs(x).max()) for x in leaves(g))
        comp_t, res_t = ef_compress_tree(to_t(g), res_t, codec=codec,
                                         topk_frac=0.1)
        comp_j, res_j = ref_c.ef_compress_tree(to_j(g), res_j, codec=codec,
                                               topk_frac=0.1)
        for a, b in zip(leaves(comp_t), leaves(comp_j)):
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max())
                        / top)
        for a, b in zip(leaves(res_t), leaves(res_j)):
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max())
                        / top)
    assert worst <= 1e-6, worst


def test_ef_compress_tree_refuses_an_unknown_codec():
    with pytest.raises(ValueError):
        ef_compress_tree({"w": torch.zeros(3)}, {"w": torch.zeros(3)},
                         codec="fp4")


@pytest.mark.parametrize("codec", CODECS)
def test_pod_sync_one_pod_matches_reference(codec):
    from repro.runtime.localsgd import pod_sync as ref_sync
    from repro.util import make_mesh_compat

    rng = np.random.default_rng(5)
    anchor = {"w": rng.normal(size=(24,)).astype(np.float32),
              "b": {"v": rng.normal(size=(4, 6)).astype(np.float32)}}
    params = {"w": anchor["w"] + 0.1 * rng.normal(size=(24,)).astype(
        np.float32), "b": {"v": anchor["b"]["v"] * np.float32(1.01)}}
    residual = {"w": 0.01 * rng.normal(size=(24,)).astype(np.float32),
                "b": {"v": np.zeros((4, 6), np.float32)}}

    def t(tree):
        return {k: t(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in tree.items()}

    def j(tree):
        return {k: j(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in tree.items()}

    mesh = make_mesh((1,), ("pod",), device="cpu")
    got = pod_sync(t(params), t(anchor), t(residual), mesh, codec=codec,
                   topk_frac=0.2)
    want = ref_sync(j(params), j(anchor), j(residual),
                    make_mesh_compat((1,), ("pod",)), codec=codec,
                    topk_frac=0.2)
    for g, w in zip(got, want):
        for key in ("w",):
            assert np.array_equal(_bits(g[key].numpy()), _bits(w[key]))
        assert np.array_equal(_bits(g["b"]["v"].numpy()),
                              _bits(w["b"]["v"]))
    assert make_pod_sync(mesh, codec=codec) is not None
    assert make_pod_sync(make_mesh((1, 1), ("data", "model"),
                                   device="cpu")) is None


def test_localsgd_check_on_two_gloo_ranks(capsys):
    from repro_torch.testing import localsgd_check as lc

    assert lc.report(lc.run("cpu"))
    out = capsys.readouterr().out
    assert "OK" in out.splitlines()[-1]
    err = float(out.split("EXACT_AVG_ERR")[1].split()[0])
    assert err < lc.EXACT_GATE


def test_elastic_check_on_four_then_two_gloo_ranks(tmp_path, capsys):
    from repro_torch.testing import elastic_check as ec

    rows = ec.run(str(tmp_path), "cpu")
    assert ec.report(rows)
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    # four ranks on 2x2, two on data=2: six blocks, each its slice
    assert len(rows) == 6
    assert {r["spec"] for r in rows} == {"P('model', 'data')",
                                         "P(None, 'data')"}


def test_serve_lm_example_runs_on_cpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(repo, "examples", "serve_lm_torch.py"),
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["requests"], out["nrhs"], out["n_node"], out["n_core"]) \
        == (8, 4, 1, 2)
    assert out["served"] == out["converged"] == 8
    assert out["device"] == "cpu" and out["recompiles"] == 0
