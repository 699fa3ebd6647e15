"""The port's ``dist_check`` and ``bench_spmv`` against the JAX
reference's, on the CPU.

The reference CLIs run as subprocesses on 8 XLA host devices; the port's
run in-process with ``--device cpu``.  Envelopes:
  * ``dist_check`` at the reference's defaults with ``--cg --fused
    --solver all --nrhs 3``: both print ``OK``; cg's and the fused CG's
    iterations within ±1 of the reference's (the rounding order, ROADMAP
    C), chebyshev's equal (an a-priori budget); pipelined_cg's count below
    the f32 plateau is set by rounding (ROADMAP C), so it is held to the
    CLI's own gates (true residual, distance to the f64 oracle) only;
  * ``bench_spmv``: the reference's keys that have a counterpart are all
    present; the per-transport census, the predicted cost and the traced
    wire bytes equal the reference's; a solver's per-iteration census and
    its split equal the reference's compiled while-body census.
"""
import json
import re

from conftest import run_subprocess
from repro_torch.testing import bench_spmv, dist_check

SMALL = ["--n-node", "4", "--n-core", "2", "--n-surface", "200",
         "--layers", "8"]


def _lines(text: str) -> dict:
    return {ln.split()[0] + ("" if ln.split()[0] != "SOLVER" else
                             " " + " ".join(ln.split()[1:3])): ln
            for ln in text.strip().splitlines()}


def _int(line: str, key: str) -> int:
    return int(re.search(rf"{key} (\d+)", line).group(1))


def test_dist_check_ok_within_the_reference_envelope(capsys):
    flags = ["--cg", "--fused", "--solver", "all", "--nrhs", "3"]
    assert dist_check.main(["--device", "cpu", *flags]) == 0
    port = _lines(capsys.readouterr().out)
    res = run_subprocess(["-m", "repro.testing.dist_check", *flags])
    assert res.returncode == 0, res.stderr[-3000:]
    ref = _lines(res.stdout)
    assert "OK" in port and "OK" in ref
    assert float(port["SPMV_REL_ERR"].split()[1]) < 5e-5
    for key, name in (("CG_ITERS", "CG_ITERS"),
                      ("FUSED_ITERS", "FUSED_ITERS"),
                      ("SOLVER cg PRECOND", "ITERS")):
        assert abs(_int(port[key], name) - _int(ref[key], name)) <= 1, key
    assert _int(port["SOLVER chebyshev PRECOND"], "ITERS") == \
        _int(ref["SOLVER chebyshev PRECOND"], "ITERS")
    for key, ln in port.items():
        if key.startswith("SOLVER"):
            assert ln.endswith(" ok"), ln


def test_dist_check_resilient_rolls_back_an_injected_fault(capsys):
    assert dist_check.main(["--device", "cpu", "--solver", "all",
                            "--check-every", "25",
                            "--inject-fault", "nan@30"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = [ln for ln in out if ln.startswith("RESILIENT")]
    assert len(res) == 3 and out[-1] == "OK"
    assert all(_int(ln, "ROLLBACKS") >= 1 and ln.endswith(" ok")
               for ln in res)


def test_dist_check_plain_backend_auto_transport(capsys):
    assert dist_check.main(["--device", "cpu", "--backend", "plain",
                            "--transport", "auto", "--format", "sell",
                            "--matrix", "graded"]) == 0
    out = capsys.readouterr().out
    assert "(auto)" in out and out.strip().endswith("OK")


def _port_bench(capsys, *flags) -> dict:
    assert bench_spmv.main(["--device", "cpu", *SMALL, *flags]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _ref_bench(*flags) -> dict:
    res = run_subprocess(["-m", "repro.testing.bench_spmv", *SMALL, *flags])
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_bench_spmv_sweep_keys_and_census_equal_reference(capsys):
    flags = ["--format", "sell", "--transport", "a2a,ring,pairwise,hier",
             "--wire-dtype", "f32,int8", "--iters", "2", "--reps", "1",
             "--warmup", "1"]
    port, ref = _port_bench(capsys, *flags), _ref_bench(*flags)
    assert set(ref) <= set(port)
    assert port["device"] == "cpu" and port["timer"] == "host_clock"
    assert port["transport"] == ref["transport"] == "sweep"
    for wd in ("f32", "int8"):
        for name, row in ref["wire"][wd].items():
            got = port["wire"][wd][name]
            assert set(row) <= set(got)
            for key in ("resolved", "predicted", "traced_wire_bytes",
                        "collectives"):
                assert got[key] == row[key], (wd, name, key)
    assert port["collectives"] == ref["collectives"]
    for key in ("n_rows", "nnz", "halo_bytes_per_node", "node_imbalance",
                "core_imbalance", "padding_waste", "node_partition"):
        assert port[key] == ref[key], key


def test_bench_spmv_solver_census_equals_reference(capsys):
    flags = ["--solver", "cg", "--nrhs", "3", "--iters", "20"]
    port, ref = _port_bench(capsys, *flags), _ref_bench(*flags)
    assert set(ref) <= set(port)
    assert port["collectives_per_iter"] == ref["collectives_per_iter"]
    assert port["census_split"] == ref["census_split"] == {
        "solver_reductions": 2, "transport_ops": 3}
    assert (port["cg_iters"], port["nrhs"]) == (ref["cg_iters"], 3)
    # the whole-program census differs by construction: the reference
    # counts its compiled module, the port its setup (a restart from
    # x = 0: one SpMV and two reductions) plus one loop body
    setup = {k: port["collectives"][k] - port["collectives_per_iter"][k]
             for k in port["collectives"]}
    assert setup == {"all-reduce": 2, "reduce-scatter": 0, "all-gather": 2,
                     "all-to-all": 1, "collective-permute": 0,
                     "collective-broadcast": 0}
