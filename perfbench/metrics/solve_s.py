"""solve_s (s, lower): the window's wall time over the solves it
completed."""


def read(rec):
    if not rec.get("solves"):
        return None
    return rec["window_s"] / rec["solves"]
