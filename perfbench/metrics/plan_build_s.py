"""plan_build_s (s, lower): the host clock around ``build_spmv_plan``.
Moves setup_s."""


def read(rec):
    return rec.get("plan_build_s")
