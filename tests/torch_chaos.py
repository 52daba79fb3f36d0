"""Kill/resume helpers for the port's journaled cluster runs (those of
``tests/chaos.py``, on the port's journal), and the row comparison that
holds the port's journal rows to the reference's.

A journal is append-only, so a kill leaves a byte prefix of the completed
run's file, and truncating that file at a byte offset is the crash.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro_torch.workflow.cluster import ClusterEngine
from repro_torch.workflow.journal import Journal, recover_run

# metric fields a warm resume may change: recovery bookkeeping only
RECOVERY_FIELDS = ("n_recoveries", "n_replayed_steps")
OUTCOME_FIELDS = ("first_alloc_gb", "final_alloc_gb", "attempts",
                  "failures", "wastage_gbh", "runtime_h", "aborted",
                  "interruptions", "tw_gbh", "grow_failures", "oom_gbh",
                  "interruption_gbh", "submit_h", "start_h", "finish_h")


def assert_results_equal(expected, got, *, allow=RECOVERY_FIELDS):
    """Bitwise SimResult equivalence: outcome by outcome in completion
    order, and every cluster metric but the ``allow``-listed ones."""
    assert (got.workflow, got.method) == (expected.workflow, expected.method)
    assert len(got.outcomes) == len(expected.outcomes)
    for a, b in zip(expected.outcomes, got.outcomes):
        assert a.task.key == b.task.key, (a.task.key, b.task.key)
        for f in OUTCOME_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.task.key, f)
    ca = dataclasses.asdict(expected.cluster)
    cb = dataclasses.asdict(got.cluster)
    for k, va in ca.items():
        if k not in allow:
            assert cb[k] == va, f"cluster metric {k}: {cb[k]!r} != {va!r}"


def run_journaled(trace, method_factory, path, *, snapshot_every=16,
                  **engine_kwargs):
    """One complete journaled run; the file at ``path`` then holds every
    byte a crash could have truncated to."""
    method = method_factory(path)
    journal = Journal.attach(method, snapshot_every=snapshot_every)
    return ClusterEngine(trace, method, journal=journal,
                         **engine_kwargs).run()


def kill_points(path, n, seed=0):
    """``n`` seeded byte offsets: a third clean line ends, the rest
    mid-line bytes, always with an early and a nearly-done cut."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    bounds = [i + 1 for i, b in enumerate(data) if b == 0x0A]
    rng = np.random.default_rng([seed, size])
    pts = set()
    lo = max(1, len(bounds) // 10)
    for i in rng.choice(len(bounds), size=min(max(1, n // 3), len(bounds)),
                        replace=False):
        pts.add(bounds[int(i)])
    while len(pts) < n:
        pts.add(int(rng.integers(bounds[lo], size)))
    pts.add(bounds[lo])
    pts.add(bounds[-2] if len(bounds) > 1 else bounds[-1])
    return sorted(pts)[:max(n, 2)]


def kill_at(path, cut, out_path):
    """The first ``cut`` bytes of ``path``: what a kill at that write
    leaves on disk."""
    with open(path, "rb") as f:
        data = f.read(cut)
    with open(out_path, "wb") as f:
        f.write(data)
    return out_path


def kill_and_resume(path, cut, trace, method_factory, *, scratch,
                    resume="warm", snapshot_every=16):
    kill_at(path, cut, scratch)
    eng = recover_run(scratch, trace, method_factory, resume=resume,
                      snapshot_every=snapshot_every)
    return eng.run(), eng


def rows_match(a, b, where, rtol):
    """Kinds, keys, strings, integers and the nesting equal; floats within
    ``rtol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            rows_match(a[k], b[k], f"{where}.{k}", rtol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            rows_match(x, y, f"{where}[{i}]", rtol)
    elif isinstance(a, float) and not isinstance(a, bool):
        assert isinstance(b, float), where
        assert b == pytest.approx(a, rel=rtol, abs=1e-9), where
    else:
        assert type(a) is type(b) and a == b, where


# risk rows across the packages: the quantile, pressure and crash exposure
# are host arithmetic on the engine's state and equal; the GB fields come
# from the models' predictions and are held to the peak path's allocation
# limit (PERF.md section 2), relative to the row's allocation
ALLOC_RTOL = 1e-2
RISK_GB = ("band_gb", "agg_pred_gb", "offset_alloc_gb", "alloc_gb")


def assert_risk_rows_match(ref, port, rtol=ALLOC_RTOL, offset_moves=0):
    """The same rows in the same order: every key, string, integer and
    priced quantity equal; the GB fields within ``rtol`` of the row's
    allocation, apart from at most ``offset_moves`` rows whose paper
    offset (``offset_alloc_gb``, an integer choice of the offset grid)
    moved."""
    assert len(port) == len(ref)
    moved = 0
    for i, (a, b) in enumerate(zip(ref, port)):
        assert sorted(a) == sorted(b), i
        for k, va in a.items():
            if k in RISK_GB:
                near = abs(b[k] - va) <= rtol * a["alloc_gb"]
                if k == "offset_alloc_gb" and not near:
                    moved += 1
                else:
                    assert near, (i, k)
            else:
                assert type(b[k]) is type(va) and b[k] == va, (i, k)
    assert moved <= offset_moves, moved
