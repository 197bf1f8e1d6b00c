"""Seconds from the process's start to the first timed call: imports, CUDA
start, loading (or, the first time, building) the index, the first
search's upload of the page layout, and one warm call of every size."""


def read(rec):
    return rec["setup_s"]
