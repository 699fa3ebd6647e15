"""The ring collective-matmul (``runtime/overlap.py``) on 4 gloo ranks on
the CPU, against the JAX package's ring and the float64 product.

One spawn of 4 ranks (a ``model=4`` mesh) runs ``ring_check``'s rank
body on its inputs (``x`` (8, 64), ``w`` (64, 32), ``default_rng(0)``):
every rank's ``y`` is within 1e-5·max|y| of the reference's ring
(``tests/torch_reference.py --ring``, 4 XLA host devices) and of
``x @ w`` in float64; the ranks accumulate in their own ring orders, so
they are not held to each other's bits (their spread is reported, and
bounded by the same gate).  ``ring_linear_rs`` is the local product bit
for bit, and ``ring_check``'s report prints ``RING_REL_ERR`` and ``OK``.
"""
import os
import tempfile

import numpy as np
import pytest

from conftest import run_subprocess
from repro_torch.testing import ring_check

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ranks():
    return ring_check.run("cpu")


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "ring.npz")
        r = run_subprocess([os.path.join(HERE, "torch_reference.py"), out,
                            "--ring"], device_count=4)
        assert r.returncode == 0, r.stderr[-3000:]
        with np.load(out) as f:
            return {k: f[k] for k in f.files}


def test_inputs_are_the_reference_checks(reference):
    x, w = ring_check.inputs()
    assert np.array_equal(x, reference["x"])
    assert np.array_equal(w, reference["w"])


@pytest.mark.parametrize("rank", range(ring_check.RANKS))
def test_each_rank_matches_the_reference_ring(ranks, reference, rank):
    y, want = ranks[rank]["y"], reference["y"]
    assert y.shape == want.shape == (8, 32) and y.dtype == np.float32
    assert np.abs(y - want).max() < ring_check.GATE * np.abs(want).max()


@pytest.mark.parametrize("rank", range(ring_check.RANKS))
def test_each_rank_matches_the_float64_product(ranks, rank):
    x, w = ring_check.inputs()
    want = x.astype(np.float64) @ w.astype(np.float64)
    err = np.abs(ranks[rank]["y"] - want).max() / np.abs(want).max()
    assert err < ring_check.GATE


def test_ring_linear_rs_is_the_local_product(ranks):
    assert all(r["rs_equal"] for r in ranks)


def test_ring_check_reports_ok(ranks, capsys):
    assert ring_check.report(ranks)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "OK"
    err = float(next(ln.split()[1] for ln in lines
                     if ln.startswith("RING_REL_ERR")))
    assert err < 1e-5
