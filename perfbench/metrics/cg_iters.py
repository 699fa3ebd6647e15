"""cg_iters (iters, lower): the mean of the iteration counts the window's
solves returned.  Moves solve_s."""


def read(rec):
    if not rec.get("iters"):
        return None
    return sum(rec["iters"]) / len(rec["iters"])
