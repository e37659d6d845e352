"""The share of the float64 reference's top-10 labels that the window's
replies hold in their first ten, over every reply of the window."""


def read(run):
    return run.verdict["recall_at_10"]
