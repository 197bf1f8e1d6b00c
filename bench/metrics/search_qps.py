"""Queries answered in the window over the window's seconds (closed loop;
every call ends in a device synchronisation)."""


def read(rec):
    return rec["answered"] / rec["window_s"]
