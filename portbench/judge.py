"""The comparison that decides ``correct``.

Every request that the window issued is judged, once the window has
closed, against the float64 reference over the same rows and queries. The
program is deterministic, so the replies of one pool batch are the same
in every request that asks it: requests with identical replies are judged
once, and each distinct set of replies is judged in full. The numbers:

- ``malformed``: replies that are not k distinct labels of the index,
  with finite distances in ascending order. Limit 0.
- ``label_gap``: the widest gap between a reported distance and the
  reference's distance of the reported label's row. It catches a label or
  a distance altered, and arithmetic below the stated precision.
- ``rank_gap`` (exact indexes): the widest gap between the reported
  distance at position j and the reference's j-th smallest distance. It
  catches a neighbour missed; a swap of near-ties moves it by their gap.
- ``recall_at_10`` (graph indexes): the share of the reference's top-10
  labels in the first ten of each reply, against the floor the
  configuration states.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .reference import Reference


def reply_arrays(replies, k: int):
    """(labels [B, k] int64 with -1, distances [B, k] float64 with +inf,
    lengths [B]) of a request's replies."""
    B = len(replies)
    labels = np.full((B, k), -1, dtype=np.int64)
    dists = np.full((B, k), np.inf, dtype=np.float64)
    lens = np.empty(B, dtype=np.int64)
    for b, r in enumerate(replies):
        n = len(r.ids)
        lens[b] = n
        m = min(n, k)
        labels[b, :m] = r.ids[:m]
        dists[b, :m] = r.scores[:m]
    return labels, dists, lens


def distinct_variants(requests, k: int) -> list[dict]:
    """The distinct reply sets among ``requests`` (records with ``pool``
    and ``replies``), each with its pool batch and how many requests
    returned it."""
    seen: dict = {}
    for rec in requests:
        labels, dists, lens = reply_arrays(rec["replies"], k)
        h = hashlib.blake2b(digest_size=16)
        for a in (labels, dists, lens):
            h.update(a.tobytes())
        key = (rec["pool"], h.digest())
        if key in seen:
            seen[key]["count"] += 1
        else:
            seen[key] = {"pool": rec["pool"], "labels": labels, "dists": dists, "lens": lens,
                         "count": 1}
    return list(seen.values())


class Truth:
    """The reference's answers for the query pool: per query the exact
    top-``k_truth`` distances and labels, and the reference for distances
    of any row."""

    def __init__(self, rows: np.ndarray, labels: np.ndarray, queries: np.ndarray, k_truth: int,
                 device):
        self.ref = Reference(rows, device, "float64")
        self.labels = labels
        self.row_of = np.empty(len(labels), dtype=np.int64)
        self.row_of[labels] = np.arange(len(labels), dtype=np.int64)
        self.queries = queries
        self.dists, rows_k = self.ref.topk(queries, k_truth)
        self.top_labels = labels[rows_k]


def judge(variants: list[dict], truth: Truth, batch: int, k: int, checks: dict) -> dict:
    """The numbers of ``checks`` (the configuration's ``checks``) over the
    distinct reply sets, each with its value and limit, and ``correct``."""
    n = len(truth.labels)
    worst = {"malformed": 0, "label_gap": 0.0, "rank_gap": 0.0}
    hits = total = 0
    for v in variants:
        labels, dists, lens = v["labels"], v["dists"], v["lens"]
        sl = slice(v["pool"] * batch, (v["pool"] + 1) * batch)
        known = (labels >= 0) & (labels < n)
        srt = np.sort(labels, axis=1)
        bad = (lens != k) | ~known.all(axis=1) | (np.diff(srt, axis=1) == 0).any(axis=1)
        finite = np.isfinite(dists).all(axis=1)
        with np.errstate(invalid="ignore"):  # inf - inf in a short reply, already counted
            bad |= ~finite | (np.diff(dists, axis=1) < 0).any(axis=1)
        worst["malformed"] += int(bad.sum()) * v["count"]
        rows = np.where(known, truth.row_of[np.where(known, labels, 0)], 0)
        ref_d = truth.ref.distances(truth.queries[sl], rows)
        ok = known & ~bad[:, None]
        if ok.any():
            worst["label_gap"] = max(worst["label_gap"], float(np.abs(dists - ref_d)[ok].max()))
            worst["rank_gap"] = max(worst["rank_gap"],
                                    float(np.abs(dists - truth.dists[sl, :k])[ok].max()))
        top = truth.top_labels[sl, :10]
        found = (labels[:, :10, None] == top[:, None, :]).any(axis=1).sum()
        hits += int(found) * v["count"]
        total += top.size * v["count"]
    numbers = dict(worst, recall_at_10=hits / total if total else 0.0)
    out = {}
    for name, lim in checks.items():
        value = numbers[name]
        if "max" in lim:
            out[name] = {"value": value, "max": lim["max"], "ok": value <= lim["max"]}
        else:
            out[name] = {"value": value, "min": lim["min"], "ok": value >= lim["min"]}
    return {"checks": out, "recall_at_10": numbers["recall_at_10"], "variants": len(variants),
            "correct": bool(variants) and all(c["ok"] for c in out.values())}


def judge_requests(requests, rows: np.ndarray, labels: np.ndarray, queries: np.ndarray,
                   traffic: dict, checks: dict, device) -> dict:
    """``judge`` over every request of ``requests`` against the float64
    reference built here from the benchmark's own rows."""
    k = int(traffic["k"])
    truth = Truth(rows, labels, queries, max(k, 10), device)
    return judge(distinct_variants(requests, k), truth, int(traffic["batch"]), k, checks)
