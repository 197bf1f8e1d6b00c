"""MemGraph navigation hops a query (QueryStats.mem_hops), over the
window's answers; nothing where the index has no MemGraph."""
from bench.metrics._read import per_query


def read(rec):
    return per_query(rec, "mem_hops") if rec["memgraph"] else None
