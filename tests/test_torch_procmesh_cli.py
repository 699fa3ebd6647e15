"""The test CLIs with ``--mesh process``, on gloo on the CPU.

Each run spawns one rank per shard (``repro_torch.launch.mesh``) and holds
the ranks to the virtual mesh: ``transport_check`` every rank's ghosts,
``y`` and census for every case x transport x wire dtype (exit 0, and 1
with the corrupting ``faulty`` registered); ``dist_check`` its lines,
``RANKS ok`` (every rank the same iterations) and its ``MESH`` line (each
rank's ``y`` bit for bit its row of the virtual mesh's, cg iterations
within ±1), with iteration counts within ±1 of ``--mesh virtual``'s,
``--transport auto`` and the resilient driver (``--check-every``, an
injected ``nan`` and a ``preempt`` that kills every rank) on the ranks.
``precond_check``, ``resilience_check``, ``serve_check`` and
``launch/serve`` with ``--mesh process``: their gates, each line's
``mesh=`` / ``RANKS`` agreement, and ``launch/serve``'s iterations equal
to the virtual mesh's.  Every CLI with ``--mesh process`` (and
``bench_spmv``) takes ``--dist-backend``: ``nccl`` is refused here, before
any work, naming the cards needed and present (this machine has none),
and without ``--mesh process`` it is a usage error.  Each run spawns its ranks (``resilience_check``
three times, through its children); the children get no jax
compatibility shim.
"""
import os
import re

import pytest

from repro_torch.launch import serve as launch_serve
from repro_torch.testing import (bench_spmv, dist_check, precond_check,
                                 resilience_check, serve_check,
                                 transport_check)

#: each CLI with ``--mesh process`` and what its parser needs besides
CLIS = {"dist_check": (dist_check, []),
        "transport_check": (transport_check, []),
        "precond_check": (precond_check, []),
        "resilience_check": (resilience_check, []),
        "serve_check": (serve_check, []),
        "bench_spmv": (bench_spmv, ["--n-node", "2", "--n-core", "2"]),
        "launch.serve": (launch_serve, [])}


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
    """These runs were once refused on a process mesh (exit 2, "virtual
    mesh only"); both now run on the ranks and print the virtual mesh's
    lines: the resilient driver's, and one ``auto`` winner for all."""
    flags = ["--device", "cpu", *argv]
    assert dist_check.main(flags) == 0
    virtual = _lines(capsys)
    assert dist_check.main(["--mesh", "process", *flags]) == 0
    out = capsys.readouterr()
    process = out.out.strip().splitlines()
    assert "virtual mesh only" not in out.err and process[-1] == "OK"
    if "--transport" in argv:
        line = [ln for ln in process if ln.startswith("TRANSPORT")][0]
        assert line.endswith("(auto)"), line
    else:
        res = [ln for ln in process if ln.startswith("RESILIENT")]
        assert len(res) == 1 and res[0].endswith("ok")
        assert res == [ln for ln in virtual if ln.startswith("RESILIENT")]


def test_dist_check_process_mesh_rolls_back_an_injected_nan(capsys):
    flags = ["--device", "cpu", "--solver", "cg,pipelined_cg",
             "--check-every", "25", "--inject-fault", "nan@30"]
    assert dist_check.main(flags) == 0
    virtual = [ln for ln in _lines(capsys) if ln.startswith("RESILIENT")]
    assert dist_check.main(["--mesh", "process", *flags]) == 0
    process = [ln for ln in _lines(capsys) if ln.startswith("RESILIENT")]
    assert process == virtual and len(process) == 2
    assert all("ROLLBACKS 1" in ln for ln in process)


def test_dist_check_process_mesh_preempt_kills_every_rank(tmp_path,
                                                          capsys):
    argv = ["--mesh", "process", "--device", "cpu", "--n-node", "2",
            "--solver", "cg", "--check-every", "10", "--inject-fault",
            "preempt@25", "--checkpoint-dir", str(tmp_path)]
    assert dist_check.main(argv) == 137
    assert "KILLED exit codes [-9, -9, -9, -9]" in _lines(capsys)
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == \
        "step_000000020"


def test_precond_check_process_mesh_holds_every_precond(capsys):
    assert precond_check.main(["--mesh", "process", "--device", "cpu"]) \
        == 0
    lines = _lines(capsys)
    pre = [ln for ln in lines if ln.startswith("PRECOND")]
    assert lines[-1] == "OK" and len(pre) == 8      # 2 formats x 4
    assert all("mesh=ok" in ln for ln in pre)


def test_precond_check_process_mesh_fails_the_faulty_precond(capsys):
    assert precond_check.main(["--mesh", "process", "--device", "cpu",
                               "--formats", "ell", "--preconds",
                               "jacobi,faulty", "--include-faulty"]) == 1
    faulty = [ln for ln in _lines(capsys) if ln.startswith(
        "PRECOND faulty")]
    assert len(faulty) == 1 and "host=" in faulty[0] and "BAD" in faulty[0]


def test_resilience_check_process_mesh_kill_and_resume(capsys):
    assert resilience_check.main(["--mesh", "process", "--device",
                                  "cpu"]) == 0
    lines = _lines(capsys)
    assert lines[-1] == "OK"
    assert any(ln.startswith("VICTIM") and "[-9, -9, -9, -9, -9, -9, -9, "
               "-9] killed-by-SIGKILL ok" in ln for ln in lines)
    assert all("RANKS ok" in ln for ln in lines if ln.startswith("CHILD"))


def test_serve_check_process_mesh(capsys):
    assert serve_check.main(["--mesh", "process", "--device", "cpu",
                             "--n-node", "2", "--n-core", "2",
                             "--min-speedup", "0"]) == 0
    lines = _lines(capsys)
    assert lines[-1] == "OK" and "RANKS 4 ITERATIONS ok" in lines
    assert any(ln.startswith("RECOMPILES [0, 0, 0, 0]") for ln in lines)


def test_launch_serve_process_mesh_matches_the_virtual_mesh(capsys):
    import json
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--n-node", "2", "--n-core", "2",
            "--tol-spread"]
    assert serve.main(argv) == 0
    virtual = json.loads(_lines(capsys)[-1])
    assert serve.main(["--mesh", "process", *argv]) == 0
    process = json.loads(_lines(capsys)[-1])
    assert process["ranks"] == 4 and process["ranks_agree"]
    assert process["iterations"] == virtual["iterations"]
    assert process["recompiles"] == 0


def test_transport_check_process_mesh_refuses_autotune(capsys):
    assert transport_check.main(["--mesh", "process", "--device", "cpu",
                                 "--autotune"]) == 2
    assert "virtual mesh only" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_refuses_nccl_naming_the_cards_needed_and_present(name):
    module, argv = CLIS[name]
    with pytest.raises(ValueError, match=r"rank\(s\) need \d+ card\(s\), "
                       r"and this host has 0 present"):
        module.main(argv + ["--mesh", "process", "--dist-backend", "nccl",
                            "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_takes_dist_backend_only_with_mesh_process(name, capsys):
    module, argv = CLIS[name]
    with pytest.raises(SystemExit) as e:
        module.main(argv + ["--dist-backend", "nccl", "--device", "cpu"])
    assert e.value.code == 2
    assert "add --mesh process" in capsys.readouterr().err


def test_dist_check_names_its_mesh_backend(capsys):
    assert dist_check.main(["--mesh", "process", "--dist-backend", "gloo",
                            "--device", "cpu", "--n-node", "2",
                            "--n-core", "2"]) == 0
    mesh = [ln for ln in _lines(capsys) if ln.startswith("MESH")]
    assert mesh[0].startswith("MESH process gloo RANKS 4 SPMV_BITWISE ok")
