"""peak_mem_gib (GiB, lower): ``torch.cuda.max_memory_allocated`` over the
program's set-up and the window: the plan, the solver's state and the
traffic's right-hand sides (the plain reference's operator, used in
set-up to make them, is freed before the plan and left out)."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2**30
