"""Durable multi-tenant scheduler service: a copy of the reference's
asyncio ``repro.serving.scheduler_service``, with its imports pointed at
the port. The service itself computes nothing on a device; each workflow's
sizing method carries its own (a ``SizeyMethod`` runs on CUDA unless it
was built with ``device="cpu"``).

Wraps the stepwise :class:`~repro_torch.workflow.cluster.ClusterEngine` in an
async submission API: tenants submit workflow *streams*, each admitted
workflow becomes one engine, and a central weighted deficit-round-robin
loop interleaves engine steps across tenants. The scheduling quantum is
one engine *step* (one event drain + one scheduling round), so fairness
is enforced at the granularity failures actually occur at: a tenant whose
workflows are stuck in an OOM storm burns only its own share of steps —
its retries cannot starve another tenant's completions (asserted in
``tests/test_torch_service.py``).

Admission is share-based: tenant ``weight`` buys ``weight / total_weight``
of ``max_concurrent`` workflow slots (at least one). A submit over the
share is a *transient* rejection retried with bounded exponential backoff
(deterministic, no jitter); a submit still rejected after ``max_retries``
backoffs raises :class:`AdmissionError` to the caller.

Durability: give the service a ``journal_dir`` and every workflow runs
journaled (one JSONL per workflow — predictor checkpoint + engine WAL,
see :mod:`repro_torch.workflow.journal`). After a service crash,
:meth:`SchedulerService.scan_unfinished` lists the journals whose runs
never reached their ``end`` marker and :meth:`SchedulerService.resume`
re-admits each one mid-workflow through the normal admission path.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
from typing import Callable

from repro_torch.core.provenance import read_jsonl_lines
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import span as _span
from repro_torch.workflow.cluster import ClusterEngine
from repro_torch.workflow.journal import WAL_KIND, Journal, recover_run
from repro_torch.workflow.simulator import SimResult
from repro_torch.workflow.trace import WorkflowTrace

__all__ = ["SchedulerService", "WorkflowHandle", "AdmissionError",
           "TransientRejection"]


class TransientRejection(Exception):
    """Tenant is at its admission share right now; retry after backoff."""


class AdmissionError(Exception):
    """Submission still rejected after the bounded backoff schedule."""


class WorkflowHandle:
    """Awaitable handle to one admitted workflow: ``await handle`` yields
    its :class:`SimResult` (or raises what the engine raised)."""

    def __init__(self, tenant: str, name: str, engine: ClusterEngine,
                 future: asyncio.Future):
        self.tenant = tenant
        self.name = name
        self.engine = engine
        self._future = future

    def __await__(self):
        return self._future.__await__()

    @property
    def done(self) -> bool:
        return self._future.done()

    def result(self) -> SimResult:
        return self._future.result()


@dataclasses.dataclass
class _Tenant:
    name: str
    weight: float
    max_active: int | None          # explicit cap; None -> share-based
    deficit: float = 0.0            # carried round-robin credit
    rr: int = 0                     # round-robin cursor over own workflows
    active: list = dataclasses.field(default_factory=list)
    steps_granted: int = 0
    n_submitted: int = 0
    n_completed: int = 0
    n_rejected_final: int = 0


class SchedulerService:
    """Central service multiplexing tenant workflow streams onto engines.

    Use as an async context manager — the scheduler loop runs while the
    ``async with`` body does, and exit drains every admitted workflow::

        svc = SchedulerService(max_concurrent=4)
        svc.add_tenant("genomics", weight=2.0)
        async with svc:
            handle = await svc.submit("genomics", trace, method)
            result = await handle
    """

    def __init__(self, *, max_concurrent: int = 8,
                 journal_dir: str | None = None,
                 snapshot_every: int = 64, max_retries: int = 6,
                 backoff_base_s: float = 0.005,
                 backoff_cap_s: float = 0.08):
        if max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1, "
                             f"got {max_concurrent}")
        self.max_concurrent = max_concurrent
        self.journal_dir = journal_dir
        self.snapshot_every = snapshot_every
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._tenants: dict[str, _Tenant] = {}
        self._loop_task: asyncio.Task | None = None
        self._closing = False
        self._slot_freed = asyncio.Event()
        self._jseq = 0

    # ------------------------------------------------------------- tenants
    def add_tenant(self, name: str, weight: float = 1.0,
                   max_active: int | None = None) -> None:
        """Register a tenant: ``weight`` sets its deficit-round-robin
        share of engine steps and its weight-proportional admission
        slots; ``max_active`` caps concurrent workflows explicitly."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if weight <= 0.0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self._tenants[name] = _Tenant(name, weight, max_active)

    def _share_cap(self, t: _Tenant) -> int:
        if t.max_active is not None:
            return t.max_active
        total_w = sum(x.weight for x in self._tenants.values())
        return max(1, int(self.max_concurrent * t.weight / total_w))

    def stats(self) -> dict[str, dict]:
        """Per-tenant scheduler counters (steps granted, active /
        submitted / completed / finally-rejected workflows) — the same
        numbers :meth:`scrape` exposes as gauges."""
        return {t.name: {"steps_granted": t.steps_granted,
                         "active": len(t.active),
                         "n_submitted": t.n_submitted,
                         "n_completed": t.n_completed,
                         "n_rejected_final": t.n_rejected_final}
                for t in self._tenants.values()}

    def scrape(self) -> str:
        """Prometheus-style text exposition of the whole process: the
        per-tenant scheduler gauges refreshed from :meth:`stats`, plus
        every registry family (predictor dispatch/trace counters, boundary
        fits, any enabled histograms) — one endpoint an operator can poll
        while workflows run."""
        reg = _obs_metrics.default_registry()
        for tenant, vals in self.stats().items():
            for stat, value in vals.items():
                reg.gauge(f"scheduler_{stat}",
                          "per-tenant scheduler state").set(value,
                                                            tenant=tenant)
        # per-workflow sizing pressure: the same engine sample risk-priced
        # methods consume (repro_torch.core.risk), exported so operators can
        # correlate tight sizing with backlog on the shared endpoint
        gauge = reg.gauge("engine_pressure",
                          "per-workflow sizing pressure in [0, 1]")
        for t in self._tenants.values():
            for handle in t.active:
                gauge.set(handle.engine.pressure(),
                          tenant=t.name, workflow=handle.name)
        return reg.scrape()

    # ----------------------------------------------------------- admission
    def _admit(self, t: _Tenant) -> None:
        if len(t.active) >= self._share_cap(t):
            raise TransientRejection(
                f"tenant {t.name!r} at its admission share "
                f"({self._share_cap(t)} active workflows)")

    async def _admit_with_backoff(self, t: _Tenant) -> None:
        with _span("service/admit", tenant=t.name):
            await self._admit_with_backoff_inner(t)

    async def _admit_with_backoff_inner(self, t: _Tenant) -> None:
        for attempt in range(self.max_retries + 1):
            try:
                self._admit(t)
                return
            except TransientRejection:
                if attempt == self.max_retries:
                    t.n_rejected_final += 1
                    raise AdmissionError(
                        f"tenant {t.name!r}: still over its admission "
                        f"share after {self.max_retries} backoff "
                        f"retries") from None
            delay = min(self.backoff_base_s * 2 ** attempt,
                        self.backoff_cap_s)
            self._slot_freed.clear()
            try:
                # wake early when a slot frees; otherwise poll on the
                # deterministic bounded-exponential schedule
                await asyncio.wait_for(self._slot_freed.wait(), delay)
            except asyncio.TimeoutError:
                pass

    def _journal_path(self, tenant: str, trace: WorkflowTrace) -> str:
        os.makedirs(self.journal_dir, exist_ok=True)
        self._jseq += 1
        return os.path.join(self.journal_dir,
                            f"{tenant}-{trace.name}-{self._jseq:04d}.jsonl")

    # ---------------------------------------------------------- submission
    async def submit(self, tenant: str, trace: WorkflowTrace, method=None,
                     *, method_factory: Callable | None = None,
                     engine_kwargs: dict | None = None,
                     name: str | None = None) -> WorkflowHandle:
        """Admit one workflow for ``tenant`` and return its handle.

        With a ``journal_dir`` the run is durable: pass ``method_factory``
        (a ``path -> method`` callable) so the method's provenance
        persists to the workflow's own journal file; a plain ``method``
        then runs journaled only if it already persists somewhere.
        """
        t = self._tenants[tenant]
        await self._admit_with_backoff(t)
        journal = None
        if self.journal_dir is not None and method_factory is not None:
            path = self._journal_path(tenant, trace)
            method = method_factory(path)
            journal = Journal.attach(method,
                                     snapshot_every=self.snapshot_every)
        elif method is None:
            raise ValueError("submit needs method or method_factory")
        engine = ClusterEngine(trace, method, journal=journal,
                               **(engine_kwargs or {}))
        return self._adopt(t, trace, engine, name)

    async def resume(self, tenant: str, trace: WorkflowTrace,
                     method_factory: Callable, path: str, *,
                     resume: str = "warm",
                     name: str | None = None) -> WorkflowHandle:
        """Re-admit a crashed journaled workflow mid-run (repairs the
        journal, warm-starts the method from it, replays the WAL tail —
        see :func:`repro_torch.workflow.journal.recover_run`)."""
        t = self._tenants[tenant]
        await self._admit_with_backoff(t)
        engine = recover_run(path, trace, method_factory, resume=resume,
                             snapshot_every=self.snapshot_every)
        return self._adopt(t, trace, engine, name)

    def _adopt(self, t: _Tenant, trace: WorkflowTrace,
               engine: ClusterEngine, name: str | None) -> WorkflowHandle:
        t.n_submitted += 1
        fut = asyncio.get_running_loop().create_future()
        handle = WorkflowHandle(
            t.name, name or f"{trace.name}#{t.n_submitted}", engine, fut)
        t.active.append(handle)
        return handle

    @staticmethod
    def scan_unfinished(journal_dir: str) -> list[str]:
        """Journal files under ``journal_dir`` whose runs never reached
        their ``end`` marker — the resume worklist after a service crash."""
        out = []
        for fn in sorted(os.listdir(journal_dir)):
            if not fn.endswith(".jsonl"):
                continue
            path = os.path.join(journal_dir, fn)
            lines, _ = read_jsonl_lines(path)
            has_wal = complete = False
            for line in lines:
                d = json.loads(line)
                if d.get("kind") == WAL_KIND:
                    has_wal = True
                    complete = d.get("rec") == "end"
            if has_wal and not complete:
                out.append(path)
        return out

    # ------------------------------------------------------ scheduler loop
    def _runnable(self) -> list[_Tenant]:
        return [t for t in self._tenants.values() if t.active]

    def _step_one(self, t: _Tenant) -> None:
        """One scheduling quantum for ``t``: step its next workflow
        (round-robin within the tenant), finalizing it if it finished."""
        t.rr %= len(t.active)
        handle = t.active[t.rr]
        try:
            with _span("service/grant", tenant=t.name, workflow=handle.name):
                alive = handle.engine.step()
        except Exception as exc:                       # engine bug/divergence
            t.active.pop(t.rr)
            t.n_completed += 1
            if not handle._future.done():
                handle._future.set_exception(exc)
            self._slot_freed.set()
            return
        t.steps_granted += 1
        if alive:
            t.rr += 1
            return
        t.active.pop(t.rr)
        t.n_completed += 1
        if not handle._future.done():
            handle._future.set_result(handle.engine.result())
        self._slot_freed.set()   # wake backoff waiters: a share slot freed

    async def _run_loop(self) -> None:
        """Weighted deficit round-robin: each pass grants every tenant
        ``weight`` step credits (fractions carry over), then spends
        credits largest-deficit-first. Per pass a weight-2 tenant gets
        twice the engine steps of a weight-1 tenant — whatever either
        tenant's workflows are doing with those steps."""
        while True:
            runnable = self._runnable()
            if not runnable:
                if self._closing:
                    return
                await asyncio.sleep(self.backoff_base_s)
                continue
            for t in runnable:
                t.deficit += t.weight
            while True:
                runnable = self._runnable()
                if not runnable:
                    break
                t = max(runnable, key=lambda x: x.deficit)
                if t.deficit < 1.0:
                    break
                t.deficit -= 1.0
                self._step_one(t)
            # idle tenants must not bank credit against future congestion
            for t in self._tenants.values():
                if not t.active:
                    t.deficit = 0.0
            await asyncio.sleep(0)   # let submits/awaiters interleave

    async def __aenter__(self) -> "SchedulerService":
        self._closing = False
        self._loop_task = asyncio.ensure_future(self._run_loop())
        return self

    async def __aexit__(self, exc_type, exc, tb) -> None:
        self._closing = True
        if self._loop_task is not None:
            if exc_type is not None:
                self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
