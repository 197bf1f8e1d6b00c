"""Mean wall time of one DiskIndex.search call of the open loop, from the
harness's span around it (ends in a device synchronisation), in ms."""


def read(rec):
    calls = rec["call_s"]
    return 1e3 * float(calls.mean()) if len(calls) else None
