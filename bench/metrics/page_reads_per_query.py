"""Charged page reads a query (QueryStats.page_reads), over the window's
answers."""
from bench.metrics._read import per_query


def read(rec):
    return per_query(rec, "page_reads")
