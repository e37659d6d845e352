"""The 95th percentile of request latency, issue to last reply, over every
request the window issued."""

from portbench.harness import latency_ms


def read(run):
    return latency_ms(run.records, 95)
