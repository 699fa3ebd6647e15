"""cg_iter_ms (ms, lower): the window's wall time over the sum of the
iterations its solves returned.  Moves solve_s."""


def read(rec):
    if not sum(rec.get("iters") or []):
        return None
    return rec["window_s"] * 1e3 / sum(rec["iters"])
