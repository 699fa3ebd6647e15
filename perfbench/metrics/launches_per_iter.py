"""launches_per_iter (launches, lower): device operations (kernels, copies,
fills) in the traced solve over the iterations it returned.  Moves
solve_s."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["launches"] or not p["iters"]:
        return None
    return p["launches"] / p["iters"]
