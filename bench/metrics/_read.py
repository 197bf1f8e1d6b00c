"""Shared arithmetic of the metric readers. A reader returns None where its
cell has nothing for it to read."""
from __future__ import annotations


def per_query(rec: dict, count: str):
    """A program counter summed over the window's answers, a query."""
    return rec["counts"][count] / rec["answered"] if rec["answered"] else None
