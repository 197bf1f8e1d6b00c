"""Frontier reads served by the vertex cache, % of all frontier reads
(QueryStats.cache_hits over cache_hits + page_reads); nothing where the
index has no cache."""


def read(rec):
    if not rec["cache"]:
        return None
    hits, pages = rec["counts"]["cache_hits"], rec["counts"]["page_reads"]
    return 100.0 * hits / (hits + pages) if hits + pages else None
