"""The replays behind the paper's evaluation (fig8a-d, table2, fig9-fig12).

The simulation half of the reference's ``benchmarks/run.py`` (``METHODS``
and ``_method`` as :func:`make`), cut into jobs so that a caller can spread
them over processes. A job is one replay: ``(workflow, scale, method,
ttf, alpha)``. :func:`jobs` lists the jobs the figures need (each once:
fig9's full retrain, fig10's default alpha and fig12's run at 0.35 are the
grid's own sizey runs), and :func:`run_job` replays one and returns its
:func:`summarize` record. The records are plain JSON, so the jobs may run
in worker processes; :func:`summarize` reads only what both packages'
results and methods share, so the same records can be taken of the
reference's replays. ``tools/port_paper.py`` builds the figures from the
records and holds them to the reference's. Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import time

import numpy as np

METHODS = ("sizey", "witt_wastage", "witt_lr", "tovar_ppm",
           "witt_percentile", "workflow_presets")
SIZEY = ("sizey", "sizey_incremental", "sizey_argmax", "sizey_temporal")
FIG9_WORKFLOW = "methylseq"
FIG10_WORKFLOW = "rnaseq"
FIG10_TASKS = ("fastqc", "markduplicates")
FIG10_ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)
FIG12_WORKFLOW = "mag"
FIG12_POOL = ("prokka", "epyc128")
FIG12_MIN_SCALE = 0.3

def default_alpha() -> float:
    from repro_torch.core import SizeyConfig
    return SizeyConfig().alpha


def job_key(workflow: str, scale: float, method: str, ttf: float,
            alpha: float | None = None) -> str:
    return (f"{workflow}/{method}/ttf={ttf}/scale={scale}"
            + ("" if alpha is None else f"/alpha={alpha}"))


def jobs(scale: float, ttfs=(1.0, 0.5), extra=(), workflows=None) -> list:
    """Every job the figures read, each once, as ``(workflow, scale, method,
    ttf, alpha)`` (alpha None: the default config). ``extra`` methods add
    table2 rows at ttf 1.0; ``workflows`` cuts the grid to a subset."""
    from repro_torch.workflow import WORKFLOWS
    if 1.0 not in ttfs:
        raise ValueError("the figures read ttf 1.0")
    wfs = list(WORKFLOWS) if workflows is None else list(workflows)
    out = [(wf, scale, m, ttf, None) for wf in wfs for ttf in ttfs
           for m in METHODS]
    out += [(FIG9_WORKFLOW, scale, m, 1.0, None)
            for m in ("sizey", "sizey_incremental")]
    a0 = default_alpha()
    out += [(FIG10_WORKFLOW, scale, "sizey", 1.0, None if a == a0 else a)
            for a in FIG10_ALPHAS]
    out += [(wf, scale, "sizey_argmax", 1.0, None) for wf in wfs]
    out.append((FIG12_WORKFLOW, max(scale, FIG12_MIN_SCALE), "sizey", 1.0,
                None))
    out += [(wf, scale, m, 1.0, None) for m in extra for wf in wfs]
    return list(dict.fromkeys(out))


def make(method: str, ttf: float, alpha: float | None = None, device=None):
    """The reference's ``_method`` (``benchmarks/run.py``), with the alpha
    of fig10 and the device of the methods that use the card."""
    from repro_torch.baselines import SizeyMethod, make_method
    from repro_torch.core import SizeyConfig
    kw = {} if alpha is None else {"alpha": alpha}
    if method == "sizey":
        return SizeyMethod(SizeyConfig(**kw), ttf=ttf, device=device)
    if method == "sizey_incremental":
        return SizeyMethod(SizeyConfig(incremental=True, **kw), ttf=ttf,
                           name="sizey_incremental", device=device)
    if method == "sizey_argmax":
        return SizeyMethod(SizeyConfig(strategy="argmax", **kw), ttf=ttf,
                           name="sizey_argmax", device=device)
    if method in ("sizey_temporal", "ks_plus"):
        return make_method(method, ttf=ttf, device=device, **kw)
    return make_method(method, ttf=ttf)


def _host(a) -> np.ndarray:
    """One copy to the host: a torch tensor on any device, or an array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def log_errors(pool) -> dict:
    """fig12 of one pool's prequential log: the raw aggregate prediction's
    relative error, early and late median and its slope per task."""
    n = int(pool.log_count)
    agg, actual = _host(pool.log_agg)[:n], _host(pool.log_actual)[:n]
    err = np.abs(agg - actual) / np.maximum(actual, 1e-9)
    half = n // 2
    return {"n": n, "early_median_rel_err": float(np.median(err[:half])),
            "late_median_rel_err": float(np.median(err[half:])),
            "slope_per_task": float(np.polyfit(np.arange(n), err, 1)[0])}


def summarize(res, method, log_pool: str = FIG12_POOL[0]) -> dict:
    """What the figures read of one replay, in plain JSON; ``res`` and
    ``method`` may be either package's. ``fig12`` is that of the
    ``log_pool`` task type's pool, where it has a log."""
    by_type: dict[str, float] = {}
    for o in res.outcomes:
        by_type[o.task.task_type] = by_type.get(o.task.task_type, 0.0) \
            + o.wastage_gbh
    out = {"n_tasks": len(res.outcomes), "wastage_gbh": res.wastage_gbh,
           "temporal_wastage_gbh": res.temporal_wastage_gbh,
           "n_failures": res.n_failures,
           "total_runtime_h": res.total_runtime_h,
           "failures_by_type": res.failures_by_type(),
           "wastage_by_type": by_type}
    pred = getattr(method, "predictor", None)
    if pred is not None and hasattr(pred, "model_select_counts"):
        times = pred.train_times_s
        out["train_ms_median"] = (float(np.median(times)) * 1e3 if times
                                  else None)
        out["n_fits"] = len(times)
        out["model_select_counts"] = [int(c)
                                      for c in pred.model_select_counts]
        out["models"] = list(pred.models)
        pool = pred.db.pools.get((log_pool, FIG12_POOL[1]))
        if pool is not None and pool.log_count > 1:
            out["fig12"] = log_errors(pool)
    return out


def run_job(job, device=None, log=print) -> dict:
    """Replay one job through the port; its :func:`summarize` record with
    the wall, and on the card the predictor's dispatches and the kernels'
    launches of this replay."""
    from repro_torch.core import predictor as P
    from repro_torch.kernels import KERNEL_LAUNCHES
    from repro_torch.workflow import generate_workflow, simulate
    wf, scale, name, ttf, alpha = job
    d0, k0 = dict(P.DISPATCH_COUNTS), dict(KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    method = make(name, ttf, alpha,
                  device=device if name in SIZEY + ("ks_plus",) else None)
    res = simulate(generate_workflow(wf, scale=scale), method, ttf=ttf)
    rec = summarize(res, method)
    rec["wall_s"] = time.perf_counter() - t0
    rec["dispatches"] = {k: P.DISPATCH_COUNTS[k] - d0.get(k, 0)
                         for k in ("predict_pool", "observe_pool",
                                   "refresh_pool")}
    rec["launches"] = {k: n - k0.get(k, 0) for k, n in KERNEL_LAUNCHES.items()
                       if n - k0.get(k, 0)}
    if log is not None:
        log(f"# sim {wf:10s} {name:18s} ttf={ttf} scale={scale}"
            f"{'' if alpha is None else f' alpha={alpha}'} "
            f"wastage={rec['wastage_gbh']:10.2f} "
            f"fail={rec['n_failures']:4d} ({rec['wall_s']:.1f}s)")
    return rec
