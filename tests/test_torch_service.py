"""The port's multi-tenant scheduler service against the reference, on the
CPU: the service cases of ``tests/test_durability.py`` on the same inputs
through both packages.

  * deficit-round-robin grants, admission and backoff give the
    reference's per-tenant stats (steps granted, submitted, completed,
    finally rejected) and the reference's completion order;
  * each workflow's result is bitwise the same engine run outside the
    service, whatever the order in which the service interleaves the
    tenants' steps;
  * a crashed service's journals are found and resumed bitwise.
"""
import asyncio
import os

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving.scheduler_service as J  # noqa: E402
import repro_torch.serving.scheduler_service as T  # noqa: E402
from repro.baselines.sizey_method import SizeyMethod as JMethod  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro_torch.baselines import SizeyMethod  # noqa: E402
from repro_torch.serving import SchedulerService  # noqa: E402
from repro_torch.workflow import generate_workflow  # noqa: E402
from repro_torch.workflow.cluster import ClusterEngine  # noqa: E402
from torch_chaos import assert_results_equal, run_journaled  # noqa: E402

CAP = 64.0
# each package's service module, trace generator and Sizey factory
PACKAGES = {
    "ref": (J, j_generate,
            lambda path=None: JMethod(machine_cap_gb=CAP, persist_path=path)),
    "port": (T, generate_workflow,
             lambda path=None: SizeyMethod(machine_cap_gb=CAP,
                                           persist_path=path, device="cpu")),
}


def _small_trace(gen, seed=2, scale=0.02):
    return gen("eager", seed=seed, scale=scale, machine_cap_gb=CAP)


def _ints(res):
    return [(o.task.key, o.attempts, o.failures, o.interruptions)
            for o in res.outcomes]


class StormMethod:
    """Always under-allocates, doubling on each retry: an OOM storm."""
    name = "storm"

    def allocate(self, task):
        return max(task.actual_peak_gb / 8.0, 0.1)

    def retry(self, task, attempt, last):
        return last * 2.0

    def complete(self, task, first, attempts):
        pass


def _completion(pkg, tmp_path):
    mod, gen, make = PACKAGES[pkg]
    service = mod.SchedulerService
    trace = _small_trace(gen)
    jd = str(tmp_path / pkg / "journals")

    async def main():
        svc = service(max_concurrent=4, journal_dir=jd, snapshot_every=16)
        svc.add_tenant("a")
        svc.add_tenant("b")
        async with svc:
            ha = await svc.submit("a", trace, method_factory=make,
                                  engine_kwargs={"n_nodes": 4})
            hb = await svc.submit("b", trace, method_factory=make,
                                  engine_kwargs={"n_nodes": 4})
            return await asyncio.gather(ha, hb), svc.stats()

    (ra, rb), stats = asyncio.run(main())
    return trace, jd, ra, rb, stats


def test_service_runs_workflows_to_completion(tmp_path):
    trace, jd, ra, rb, stats = _completion("port", tmp_path)
    assert len(ra.outcomes) == len(trace.tasks)
    assert len(rb.outcomes) == len(trace.tasks)
    assert ra.wastage_gbh == rb.wastage_gbh
    assert SchedulerService.scan_unfinished(jd) == []
    assert len(os.listdir(jd)) == 2
    # bitwise the same journaled engine run outside the service
    outside = run_journaled(trace, PACKAGES["port"][2],
                            str(tmp_path / "outside.jsonl"), n_nodes=4)
    assert_results_equal(outside, ra, allow=())
    _t, _jd, ja, _jb, j_stats = _completion("ref", tmp_path)
    assert stats == j_stats
    assert _ints(ra) == _ints(ja)


def _fair_share(pkg):
    mod, gen, make = PACKAGES[pkg]
    service = mod.SchedulerService
    trace = _small_trace(gen, scale=0.03)

    async def main():
        svc = service(max_concurrent=4)
        svc.add_tenant("heavy", weight=3.0)
        svc.add_tenant("light", weight=1.0)
        order = []
        async with svc:
            hh = await svc.submit("heavy", trace, make(),
                                  engine_kwargs={"n_nodes": 4})
            hl = await svc.submit("light", trace, make(),
                                  engine_kwargs={"n_nodes": 4})
            for h, tag in ((hh, "heavy"), (hl, "light")):
                async def watch(h=h, tag=tag):
                    await h
                    order.append(tag)
                asyncio.ensure_future(watch())
            out = await asyncio.gather(hh, hl)
            await asyncio.sleep(0)
        return order, svc.stats(), out

    return asyncio.run(main())


def test_service_weighted_fair_share():
    order, stats, (rh, rl) = _fair_share("port")
    assert order[0] == "heavy"
    assert stats["heavy"]["steps_granted"] == stats["light"]["steps_granted"]
    j_order, j_stats, (jh, _jl) = _fair_share("ref")
    assert (order, stats) == (j_order, j_stats)
    assert _ints(rh) == _ints(rl) == _ints(jh)


def _storm(pkg):
    mod, gen, make = PACKAGES[pkg]
    service = mod.SchedulerService
    storm_trace = _small_trace(gen, seed=7, scale=0.06)
    calm_trace = _small_trace(gen, seed=2, scale=0.02)

    async def main():
        svc = service(max_concurrent=4)
        svc.add_tenant("storm")
        svc.add_tenant("calm")
        async with svc:
            hs = await svc.submit("storm", storm_trace, StormMethod(),
                                  engine_kwargs={"n_nodes": 2})
            hc = await svc.submit("calm", calm_trace, make(),
                                  engine_kwargs={"n_nodes": 2})
            rc = await hc
            storm_still_running = not hs.done
            rs = await hs
        return rc, rs, storm_still_running, svc.stats()

    return asyncio.run(main())


def test_service_oom_storm_cannot_starve_other_tenant():
    rc, rs, storm_still_running, stats = _storm("port")
    assert storm_still_running
    assert not any(o.aborted for o in rc.outcomes)
    assert rs.n_failures > 0
    solo = 0
    eng = ClusterEngine(_small_trace(generate_workflow), PACKAGES["port"][2](),
                        n_nodes=2)
    while eng.step():
        solo += 1
    assert stats["calm"]["steps_granted"] == solo + 1
    j_rc, j_rs, j_running, j_stats = _storm("ref")
    assert stats == j_stats and storm_still_running == j_running
    # the storm's method is plain Python: its result is the reference's
    assert rs.wastage_gbh == j_rs.wastage_gbh and _ints(rs) == _ints(j_rs)
    assert _ints(rc) == _ints(j_rc)


def _admission(pkg):
    mod, gen, make = PACKAGES[pkg]
    service = mod.SchedulerService
    big = _small_trace(gen, seed=1, scale=0.05)
    small = _small_trace(gen, seed=2, scale=0.02)

    async def main():
        svc = service(max_concurrent=1, max_retries=2,
                      backoff_base_s=0.001, backoff_cap_s=0.002)
        svc.add_tenant("t", max_active=1)
        with pytest.raises(mod.TransientRejection):
            async with svc:
                await svc.submit("t", big, make(),
                                 engine_kwargs={"n_nodes": 1})
                svc._admit(svc._tenants["t"])
        svc2 = service(max_concurrent=1, max_retries=2,
                       backoff_base_s=0.001, backoff_cap_s=0.002)
        svc2.add_tenant("t", max_active=1)
        async with svc2:
            h1 = await svc2.submit("t", big, make(),
                                   engine_kwargs={"n_nodes": 1})
            with pytest.raises(mod.AdmissionError):
                await svc2.submit("t", small, make(),
                                  engine_kwargs={"n_nodes": 1})
            await h1
            h2 = await svc2.submit("t", small, make(),
                                   engine_kwargs={"n_nodes": 1})
            await h2
        return svc.stats(), svc2.stats()

    return asyncio.run(main())


def test_service_admission_backoff_and_rejection():
    first, second = _admission("port")
    assert second["t"]["n_rejected_final"] == 1
    assert second["t"]["n_completed"] == 2
    j_first, j_second = _admission("ref")
    # the first service was torn down mid-run: its counts depend on the
    # moment of the probe, so only the drained service is compared
    assert first["t"]["n_submitted"] == j_first["t"]["n_submitted"] == 1
    assert second == j_second


def test_service_crash_scan_and_resume(tmp_path):
    make = PACKAGES["port"][2]
    trace = _small_trace(generate_workflow, seed=4, scale=0.03)
    jd = str(tmp_path / "journals")
    os.makedirs(jd)
    base_path = os.path.join(jd, "t-eager-0001.jsonl")
    baseline = run_journaled(trace, make, base_path, snapshot_every=8,
                             n_nodes=2)
    blob = open(base_path, "rb").read()
    open(base_path, "wb").write(blob[:len(blob) // 2 + 9])

    async def main():
        assert SchedulerService.scan_unfinished(jd) == [base_path]
        svc = SchedulerService(max_concurrent=2, journal_dir=jd,
                               snapshot_every=8)
        svc.add_tenant("t")
        async with svc:
            h = await svc.resume("t", trace, make, base_path)
            return await h

    res = asyncio.run(main())
    assert_results_equal(baseline, res)
    assert SchedulerService.scan_unfinished(jd) == []


@pytest.mark.parametrize("first", ["genomics", "imaging"])
def test_results_do_not_depend_on_the_interleaving(first):
    """Two tenants of weights 2 and 1 submit two different workflows, in
    either order: each result is bitwise its engine run outside the
    service."""
    make = PACKAGES["port"][2]
    traces = {"genomics": _small_trace(generate_workflow, seed=5),
              "imaging": _small_trace(generate_workflow, seed=6,
                                      scale=0.03)}
    order = [first] + [t for t in traces if t != first]

    async def main():
        svc = SchedulerService(max_concurrent=4)
        svc.add_tenant("genomics", weight=2.0)
        svc.add_tenant("imaging", weight=1.0)
        async with svc:
            handles = {t: await svc.submit(t, traces[t], make(),
                                           engine_kwargs={"n_nodes": 2})
                       for t in order}
            return {t: await h for t, h in handles.items()}

    got = asyncio.run(main())
    for tenant, trace in traces.items():
        outside = ClusterEngine(trace, make(), n_nodes=2).run()
        assert_results_equal(outside, got[tenant], allow=())
