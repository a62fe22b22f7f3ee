"""Seconds of ``Hnsw.build`` in set-up, by the host clock between two
device synchronisations."""


def read(ctx):
    return ctx["counters"].get("build_s")
