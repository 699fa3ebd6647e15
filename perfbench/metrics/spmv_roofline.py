"""spmv_roofline (%, higher): the least time one plan SpMV can take
on the card over the time it took.  The bound is the operator's bytes
(``perfbench.peaks.spmv_bytes``: true nnz x 8 B, x and y 4 B a row) over
the card's peak bandwidth; the time is one ``make_spmv(plan)`` call,
CUDA events over back-to-back calls, whatever kernels implement it.
Not clamped: a share above 100 means the bytes are counted too high or
the time leaves work out.  Moves solve_s."""

from perfbench.peaks import spmv_bytes


def read(rec):
    if not rec.get("spmv_ms") or not rec.get("bytes_per_s"):
        return None
    bound_s = spmv_bytes(rec["nnz"], rec["n"]) / rec["bytes_per_s"]
    return bound_s / (rec["spmv_ms"] / 1e3) * 100
