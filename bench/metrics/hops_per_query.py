"""Disk-search hops a query (QueryStats.hops), over the window's answers."""
from bench.metrics._read import per_query


def read(rec):
    return per_query(rec, "hops")
