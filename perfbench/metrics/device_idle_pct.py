"""device_idle_pct (%, lower): the share of the traced solve's window in
which no device operation runs.  Moves solve_s."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["busy_s"]:
        return None
    return p["idle_share"] * 100
