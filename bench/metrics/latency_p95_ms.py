"""The 95th percentile, by nearest rank, of the latencies of all queries
that arrived in the window, each from when it was due to when its call
returned, synchronised (open loop)."""
from bench.traffic import nearest_rank


def read(rec):
    lat = rec["latencies_s"]
    if lat is None or not len(lat):
        return None
    return 1e3 * nearest_rank(lat, 95)
