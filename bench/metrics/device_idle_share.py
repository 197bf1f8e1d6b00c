"""% of the traced facade calls' wall time covered by no device operation
(torch.profiler; union of kernel, copy and set intervals); nothing where
the run was not traced or the trace held no call."""


def read(rec):
    p = rec["profile"]
    if p is None or not p["call_s"] > 0:
        return None
    return 100.0 * (1.0 - p["call_busy_s"] / p["call_s"])
