"""Rows per second of the set-up's ``bulk_build_device`` call, timed to a
device synchronisation."""


def read(run):
    return run.built.get("build_vps")
