"""The per-layer and end-to-end readers and the roofline arithmetic."""
import json
from pathlib import Path

import pytest

from perfbench import harness, peaks

METRICS = Path(harness.ROOT) / "perfbench" / "metrics"
BENCH = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
#: every reader, those no cell of BENCHMARK.json lists yet included
READERS = sorted(p.stem for p in METRICS.glob("*.py"))


def test_spmv_bytes_count_the_operator_not_the_storage():
    # each true entry's value and column once, x read and y written once
    assert peaks.spmv_bytes(nnz=10, n=3) == 10 * 8 + 3 * 4 + 3 * 4
    assert peaks.spmv_bytes(nnz=75_320_288, n=3_360_000) == 629_442_304


def test_peaks_by_card_name():
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert peaks.peaks("NVIDIA H100 PCIe")["bytes_per_s"] == 2.0e12
    assert peaks.peaks("cpu") is None


def roofline(rec):
    return harness.read_metric({"name": "spmv_roofline"}, rec, METRICS)


def test_roofline_share_is_bound_over_time_and_never_clamped():
    rec = {"nnz": 75_320_288, "n": 3_360_000, "bytes_per_s": 3.35e12}
    bound_ms = 629_442_304 / 3.35e12 * 1e3
    assert roofline(dict(rec, spmv_ms=2 * bound_ms)) == pytest.approx(50.0)
    # a time under the bound reads above 100: the fault shows, not hidden
    assert roofline(dict(rec, spmv_ms=bound_ms / 1.2)) == pytest.approx(120.0)
    assert roofline(dict(rec, spmv_ms=0.0)) is None         # nothing timed
    assert roofline({"nnz": 1, "n": 1, "spmv_ms": 1.0}) is None  # no peak


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_nothing_from_nothing(name):
    assert harness.read_metric({"name": name}, {}, METRICS) is None


def test_every_listed_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["name"] in READERS


def test_readers_on_a_record():
    one = {"window_s": 10.0, "solves": 20, "iters": [500] * 20,
           "peak_bytes": 2**30, "setup_s": 30.0, "plan_build_s": 11.0,
           "profile": {"busy_s": 0.3, "window_s": 0.4, "launches": 3500,
                       "iters": 100, "idle_share": 0.25}}
    read = {n: harness.read_metric({"name": n}, one, METRICS)
            for n in READERS}
    assert read["solve_s"] == 0.5
    assert read["cg_iters"] == 500 and read["cg_iter_ms"] == 1.0
    assert read["launches_per_iter"] == 35 and read["device_idle_pct"] == 25
    assert read["peak_mem_gib"] == 1.0 and read["setup_s"] == 30.0
    assert read["plan_build_s"] == 11.0
