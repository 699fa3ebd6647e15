"""``dist_check`` and ``transport_check`` with ``--mesh process``, on gloo
on the CPU.

Each run spawns one rank per shard (``repro_torch.launch.mesh``) and holds
the ranks to the virtual mesh: ``transport_check`` every rank's ghosts,
``y`` and census for every case x transport x wire dtype (exit 0, and 1
with the corrupting ``faulty`` registered); ``dist_check`` its lines,
``RANKS ok`` (every rank the same iterations) and its ``MESH`` line (each
rank's ``y`` bit for bit its row of the virtual mesh's, cg iterations
within ±1), with iteration counts within ±1 of ``--mesh virtual``'s.
Four spawns, about 5 s each; the children get no jax compatibility shim.
"""
import os
import re

import pytest

from repro_torch.testing import dist_check, transport_check


@pytest.fixture(autouse=True)
def _no_jax_shim_in_the_ranks(monkeypatch):
    shim = os.path.join("tests", "_jaxcompat")
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and not p.rstrip("/").endswith(shim)]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(path))


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_transport_check_process_mesh_every_case_and_wire(capsys):
    argv = ["--mesh", "process", "--device", "cpu", "--case", "all",
            "--wire-dtype", "all"]
    assert transport_check.main(argv) == 0
    lines = _lines(capsys)
    sweep = [ln for ln in lines if ln.startswith("TRANSPORT")]
    # 5 cases x 2 formats x 3 wire dtypes x 4 transports
    assert len(sweep) == 120 and lines[-1] == "OK"
    assert all("BAD" not in ln for ln in sweep)
    assert sum("ghost=ok" in ln for ln in sweep) == 96   # all but halofree


def test_transport_check_process_mesh_fails_faulty(capsys):
    argv = ["--mesh", "process", "--device", "cpu", "--case", "graded",
            "--include-faulty"]
    assert transport_check.main(argv) == 1
    faulty = [ln for ln in _lines(capsys) if ln.startswith(
        "TRANSPORT faulty")]
    assert len(faulty) == 2
    assert all("ghost=BAD" in ln and "spmv=BAD" in ln for ln in faulty)


def test_dist_check_process_mesh_at_its_defaults(capsys):
    assert dist_check.main(["--mesh", "process", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    mesh = [ln for ln in lines if ln.startswith("MESH")]
    assert lines[-1] == "OK" and len(mesh) == 1
    assert "RANKS 8 SPMV_BITWISE ok" in mesh[0] and mesh[0].endswith("ok")


def _iters(lines):
    """Every iteration count the lines print, in order."""
    out = []
    for ln in lines:
        m = re.search(r"(?:CG_ITERS|FUSED_ITERS|ITERS) (\[[^\]]*\]|\d+)", ln)
        if m and not ln.startswith("MESH"):
            out += [int(v) for v in re.findall(r"\d+", m.group(1))]
    return out


def test_dist_check_process_mesh_iterations_match_the_virtual_mesh(capsys):
    flags = ["--device", "cpu", "--cg", "--fused", "--solver",
             "cg,pipelined_cg", "--nrhs", "3"]
    assert dist_check.main(flags) == 0
    virtual = _lines(capsys)
    assert dist_check.main(["--mesh", "process", *flags]) == 0
    process = _lines(capsys)
    assert process[-1] == "OK"
    assert all("RANKS ok" in ln for ln in process
               if ln.startswith(("CG_ITERS", "FUSED_ITERS")))
    want, got = _iters(virtual), _iters(process)
    assert len(want) == len(got) == 10, (want, got)
    assert all(abs(a - b) <= 1 for a, b in zip(got, want)), (got, want)


@pytest.mark.parametrize("argv", [["--check-every", "25", "--solver", "cg"],
                                  ["--transport", "auto"]])
def test_dist_check_process_mesh_refuses_virtual_only_runs(argv, capsys):
    assert dist_check.main(["--mesh", "process", "--device", "cpu",
                            *argv]) == 2
    assert "virtual mesh only" in capsys.readouterr().err


def test_transport_check_process_mesh_refuses_autotune(capsys):
    assert transport_check.main(["--mesh", "process", "--device", "cpu",
                                 "--autotune"]) == 2
    assert "virtual mesh only" in capsys.readouterr().err
