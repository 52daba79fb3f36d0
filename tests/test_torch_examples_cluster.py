"""``examples/port_sizey_cluster.py`` against ``examples/sizey_cluster.py``
on the CPU, on the port's committed dry-run rows
(``results/dryrun_train_seq_shard.jsonl``: 40 cells, all train_4k), and
the cause of the NaN both print there.

Both job loops run side by side in two processes
(``tools/port_tolerance.py``'s ``sizey_cluster_jobs``: the scripts' own
``main`` with each job's pool, first allocation and retry ladder
recorded). Limits: the printed lines equal (``nan`` both); each first
allocation finite in both within 1e-2 (phase 6's allocation limit); the
non-finite ones all in one pool, the same jobs in both from the port's
first breakdown on, the reference's extra ones only that pool's jobs
between the reference's breakdown and the port's; the OOM retries. The
reference's own spread under 16 1-ulp moves of the MLP init
(``tools/port_tolerance.py --sizey-cluster ... --samples 16``) moves its
allocations by 2.275e-7 and its OOM retries not at all (186 in every
move), so its twice is 0: the port's retries are held job by job
instead, equal but where the ladder's first step is a tie at that
rounding, or where the reference's allocation is NaN (the port's 187).

The cause: every job of a dry-run cell has the same features
(``launch/sizing.py::job_features`` reads only the arch, the shape and
the card count), so a pool's X'X is rank one. Its entries grow with the
pool's count, and their fp32 rounding error passes the ridge
(``ridge_lambda`` 1e-4) from the pool's 20th sample on: the
factorization of X'X + 1e-4 I, positive definite in exact arithmetic,
breaks down in fp32, and the linear model's
weights, its prediction, the RAQ scores, the gate's weights and the
allocation are NaN. X'X is bitwise equal in the two packages; the
reference's LAPACK (OpenBLAS, through jaxlib) breaks down first at the
pool's 22nd sample, the port's (MKL) at its 24th.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SizeyConfig as JSizeyConfig
from repro.core.models import linear as jlinear
from repro.launch.sizing import job_features as j_job_features
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.config import SizeyConfig
from repro_torch.core.models import linear
from repro_torch.launch.sizing import job_features

REPO = pathlib.Path(__file__).resolve().parent.parent
DRYRUN = "results/dryrun_train_seq_shard.jsonl"
ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}
ALLOC_RTOL = 1e-2
POOL = ("grok-1-314b/train", "single")
# the reference's OOM retries on these rows (tools/port_tolerance.py
# --sizey-cluster, PERF.md §2)
REF_OOMS = 186
RUNNER = ("import json, runpy, sys\n"
          "tol = runpy.run_path('tools/port_tolerance.py', "
          "run_name='port_tolerance')\n"
          "jobs, text = tol['sizey_cluster_jobs'](sys.argv[2], "
          "port=sys.argv[1] == 'port')\n"
          "json.dump({'jobs': jobs, 'text': text}, open(sys.argv[3], 'w'))\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sizey_cluster")
    procs = {side: subprocess.Popen(
        [sys.executable, "-c", RUNNER, side, DRYRUN, str(out / side)],
        cwd=REPO, env=ENV, stderr=subprocess.PIPE, text=True)
        for side in ("ref", "port")}
    for side, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{side}: {err[-3000:]}"
    return {side: json.loads((out / side).read_text()) for side in procs}


def pool_history(pool=POOL):
    """The pool's samples in the scripts' order: each job's draws do not
    depend on the sizer, so the stream is the scripts' own."""
    cells = []
    for line in open(REPO / DRYRUN):
        r = json.loads(line)
        if r.get("status") == "ok":
            cells.append((r["arch"], r["shape"], r["mesh"],
                          r["memory"]["peak_gb"]))
    rng = np.random.default_rng(0)
    jobs, feats, peaks = [], [], []
    for i in range(600):
        arch, shape, mesh, true_peak = cells[rng.integers(len(cells))]
        peak = float(true_peak * rng.uniform(0.9, 1.1))
        rng.uniform(0.2, 2.0)
        if (f"{arch}/{SHAPES[shape].kind}", mesh) == pool:
            chips = 256 if mesh == "single" else 512
            jobs.append(i)
            feats.append(job_features(get_config(arch), SHAPES[shape],
                                      chips))
            peaks.append(peak)
    return jobs, np.asarray(feats, np.float32), np.asarray(peaks, np.float32)


def buffers(feats, peaks, n, cap=64):
    xs = np.zeros((cap, feats.shape[1]), np.float32)
    ys = np.zeros(cap, np.float32)
    mask = np.zeros(cap, np.float32)
    xs[:n], ys[:n], mask[:n] = feats[:n], peaks[:n], 1.0
    return xs, ys, mask


@pytest.fixture(scope="module")
def breakdowns():
    """For n = 2..30 samples of the pool: X'X in both packages, and
    whether each one's fit (the reference's jitted, as its predictor runs
    it) gives finite weights."""
    _, feats, peaks = pool_history()
    jfit = jax.jit(lambda x, y, m: jlinear.fit(x, y, m, None,
                                               JSizeyConfig()))
    out = {}
    for n in range(2, 31):
        xs, ys, mask = buffers(feats, peaks, n)
        js = jfit(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask))
        ts = linear.fit(torch.from_numpy(xs), torch.from_numpy(ys),
                        torch.from_numpy(mask), None, SizeyConfig())
        out[n] = {"j_xtx": np.asarray(js.xtx), "t_xtx": ts.xtx.numpy(),
                  "j_ok": bool(np.isfinite(np.asarray(js.w)).all()),
                  "t_ok": bool(torch.isfinite(ts.w).all()),
                  "t_w": ts.w.numpy()}
    return out


def _line(text: str, start: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith(start))


def test_every_job_of_the_pool_has_the_same_features():
    jobs, feats, _ = pool_history()
    assert len(jobs) > 30 and len({tuple(f) for f in feats}) == 1
    cfg = get_config(POOL[0].split("/")[0])
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config
    assert j_job_features(j_get_config(POOL[0].split("/")[0]),
                          J_SHAPES["train_4k"], 256) == \
        job_features(cfg, SHAPES["train_4k"], 256)


def test_the_fp32_factorization_breaks_down_in_both_packages(breakdowns):
    """X'X bitwise equal in the two packages. In exact arithmetic X'X is
    rank one and X'X + 1e-4 I has its least eigenvalue at the ridge at
    every count; the fp32 rounding error of X'X's entries, E, grows with
    the count and passes the ridge from the 20th sample on. While
    ||E|| < 1e-4 no factorization can break down (Weyl); past it each
    package's fp32 fit gives NaN weights from a count on: the
    reference's first at 22, the port's at 24."""
    _, feats, peaks = pool_history()
    err = {}
    for n, b in breakdowns.items():
        assert np.array_equal(b["j_xtx"], b["t_xtx"]), n
        xs, _, mask = buffers(feats, peaks, n)
        xa = np.concatenate([xs, np.ones((len(xs), 1), np.float32)], 1) \
            .astype(np.float64) * mask[:, None]
        exact = xa.T @ xa
        assert abs(np.linalg.eigvalsh(exact + 1e-4 * np.eye(4)).min()
                   - 1e-4) < 1e-9, n
        err[n] = np.linalg.norm(b["j_xtx"].astype(np.float64) - exact, 2)
    assert min(n for n, e in err.items() if e > 1e-4) == 20
    j_first = min(n for n, b in breakdowns.items() if not b["j_ok"])
    t_first = min(n for n, b in breakdowns.items() if not b["t_ok"])
    assert (j_first, t_first) == (22, 24)
    assert all(err[n] > 1e-4 for n, b in breakdowns.items()
               if not (b["j_ok"] and b["t_ok"]))


def test_a_breakdown_makes_the_weights_nan_as_in_the_reference(breakdowns):
    """Where the port's Cholesky breaks down, every weight is NaN, as the
    reference's factor is (``cholesky_ex`` alone leaves a partial factor,
    whose weights can be finite: at 28 samples they were about 1e6)."""
    for n, b in breakdowns.items():
        a = torch.from_numpy(b["t_xtx"]) + 1e-4 * torch.eye(4)
        _, info = torch.linalg.cholesky_ex(a)
        assert (int(info) == 0) == b["t_ok"], n
        if not b["t_ok"]:
            assert np.isnan(b["t_w"]).all(), n
    assert not breakdowns[28]["j_ok"] and not breakdowns[28]["t_ok"]


def test_printed_lines_are_the_reference(runs):
    ref, port = runs["ref"]["text"], runs["port"]["text"]
    for start in ("jobs:", "static-preset wastage:", "reduction:"):
        assert _line(port, start) == _line(ref, start)
    pat = re.compile(r"sizey wastage:\s+(\S+) GBh/chip \((\d+) OOM retries\)")
    (pw, pn), (rw, rn) = (pat.search(t).groups() for t in (port, ref))
    assert pw == rw == "nan" and int(rn) == REF_OOMS
    assert abs(int(pn) - int(rn)) <= 1


def test_allocations_job_by_job(runs, breakdowns):
    ref, port = runs["ref"]["jobs"], runs["port"]["jobs"]
    assert len(ref) == len(port) == 600
    for i, (a, b) in enumerate(zip(ref, port)):
        assert (a["pool"], a["machine"]) == (b["pool"], b["machine"]), i
        if np.isfinite(a["alloc"]) and np.isfinite(b["alloc"]):
            assert a["source"] == b["source"], i
            assert abs(b["alloc"] - a["alloc"]) <= ALLOC_RTOL * a["alloc"], i
    bad_ref = {i for i, a in enumerate(ref) if not np.isfinite(a["alloc"])}
    bad_port = {i for i, b in enumerate(port) if not np.isfinite(b["alloc"])}
    assert {(ref[i]["pool"], ref[i]["machine"])
            for i in bad_ref | bad_port} == {POOL}
    # each package's first non-finite allocation is the pool's first job
    # after its own factorization broke down
    jobs, _, _ = pool_history()
    j_first = min(n for n, b in breakdowns.items() if not b["j_ok"])
    t_first = min(n for n, b in breakdowns.items() if not b["t_ok"])
    assert min(bad_ref) == jobs[j_first] and ref[min(bad_ref)]["count"] == \
        j_first
    assert min(bad_port) == jobs[t_first]
    # from there on the same jobs; before, only the pool's jobs between
    # the two breakdowns
    assert bad_port <= bad_ref
    assert bad_ref - bad_port == set(jobs[j_first:t_first])


def test_oom_retries_on_jobs_both_size(runs):
    """A job's retries differ only where the ladder's first step is a tie:
    it retries at the pool's largest peak seen when that lies above the
    failed allocation, else doubles it, and the two packages' first
    allocations lie on either side of that peak (jobs 50 and 54, 1.7e-7
    apart). The port's total is the reference's plus those steps and the
    retries of the jobs the reference sizes with NaN, which its ladder
    never retries (``alloc < peak`` is false)."""
    ref, port = runs["ref"]["jobs"], runs["port"]["jobs"]
    ties = 0
    for a, b in zip(ref, port):
        if not (np.isfinite(a["alloc"]) and np.isfinite(b["alloc"])):
            continue
        if len(a["retries"]) != len(b["retries"]):
            assert abs(len(a["retries"]) - len(b["retries"])) == 1
            lo, hi = sorted((a["alloc"], b["alloc"]))
            assert any(lo <= r[0] <= hi for r in (a["retries"],
                                                  b["retries"]) if r)
            ties += len(b["retries"]) - len(a["retries"])
    extra = sum(len(b["retries"]) for a, b in zip(ref, port)
                if not np.isfinite(a["alloc"]))
    assert sum(len(a["retries"]) for a in ref) == REF_OOMS
    assert sum(len(b["retries"]) for b in port) == REF_OOMS + ties + extra
