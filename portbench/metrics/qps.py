"""Queries answered per second: every reply of the requests the window
issued, over the seconds from its opening until the last of them returned."""


def read(run):
    return sum(r.get("answered", 0) for r in run.records) / (run.t_end - run.t_open)
