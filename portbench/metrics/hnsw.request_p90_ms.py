"""The 90th percentile of request latency in a graph cell, issue to last
reply, over every request of an untraced window. The profiler's activity
records slow the beam's launch-bound host loop by about half again, so a
traced run first runs this window without them (``WINDOW``)."""

from portbench.harness import latency_ms

WINDOW = "untraced"


def read(run):
    return latency_ms(run.untraced.records, 90) if run.untraced is not None else None
