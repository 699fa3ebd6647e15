"""setup_s (s, lower): process start to the first timed solve: the
operator (made, or loaded once made), the traffic's right-hand sides, the
plan, upload, warm-up."""


def read(rec):
    return rec.get("setup_s")
