"""The port's slice as a whole against the reference, on the CPU.

  * the framework-free modules are bitwise: every workflow generates the
    same trace, field for field;
  * Sizey replays methylseq through both packages with equal integer
    choices and allocations within the measured tolerance;
  * the port imports neither JAX nor the reference package;
  * its entry points refuse to run without a GPU unless asked for the CPU.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# the port runs thousands of tiny ops per replay: one intra-op thread per
# test process (the suite runs several) is faster than a spinning pool
torch.set_num_threads(1)

from repro.baselines import SizeyMethod as JMethod  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs.trace import tracing as j_tracing  # noqa: E402
from repro.workflow import WORKFLOWS as J_WORKFLOWS  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro_torch.baselines import SizeyMethod  # noqa: E402
from repro_torch.core.predictor import SizeyPredictor  # noqa: E402
from repro_torch.core.provenance import ProvenanceDB  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs.trace import tracing as t_tracing  # noqa: E402
from repro_torch.workflow import WORKFLOWS, generate_workflow, simulate  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# The reference's own spread (tools/port_tolerance.py: one-ulp moves of
# the MLP's initial weights, methylseq at scale 0.05, on a CPU) reached
# 5.3e-3 on an allocation and 9.2e-5 on the total wastage, with no
# integer choice moving. The port is held to twice those figures: its
# Adam steps round differently from the reference's at every step, and
# the learning-rate choice of HPO can flip on a pool of 4 tasks where all
# three rates fit to rounding noise (methylseq_t03 and _t05 at this
# scale; the allocations still agree to 2.7e-3).
ALLOC_RTOL = 1e-2
WASTAGE_RTOL = 2e-4


@pytest.mark.parametrize("name", sorted(J_WORKFLOWS))
def test_generated_traces_are_field_for_field_equal(name):
    assert sorted(WORKFLOWS) == sorted(J_WORKFLOWS)
    a, b = j_generate(name, scale=0.3, seed=7), generate_workflow(
        name, scale=0.3, seed=7)
    assert (a.name, a.machine_cap_gb) == (b.name, b.machine_cap_gb)
    assert len(a.tasks) == len(b.tasks)
    for ta, tb in zip(a.tasks, b.tasks):
        assert dataclasses.asdict(ta) == dataclasses.asdict(tb)


def _replay(gen, sim, method, scale=0.05):
    decisions = []
    predict = method.predictor.predict

    def recording(*a, **k):
        d = predict(*a, **k)
        decisions.append(d)
        return d

    method.predictor.predict = recording
    return sim(gen("methylseq", scale=scale), method), decisions


def test_methylseq_replay_matches_reference():
    with j_tracing() as jt:
        rj, dj = _replay(j_generate, j_simulate, JMethod())
    with t_tracing() as tt:
        rt, dt = _replay(generate_workflow, simulate,
                         SizeyMethod(device="cpu"))
    # one predict span per dispatch, one observe span per retrain
    assert jt.span_counts == tt.span_counts
    assert len(rj.outcomes) == len(rt.outcomes) == 44
    assert rj.n_failures == rt.n_failures
    assert [o.attempts for o in rj.outcomes] == \
        [o.attempts for o in rt.outcomes]
    assert len(dj) == len(dt)
    n_model = 0
    for a, b in zip(dj, dt):
        assert a.source == b.source
        if a.source == "model":
            n_model += 1
            assert a.offset_idx == b.offset_idx
            assert int(np.argmax(a.raq)) == int(np.argmax(b.raq))
        np.testing.assert_allclose(b.allocation_gb, a.allocation_gb,
                                   rtol=ALLOC_RTOL)
    assert n_model > 10          # 17 of the 44 decisions are the models'
    np.testing.assert_allclose(rt.wastage_gbh, rj.wastage_gbh,
                               rtol=WASTAGE_RTOL)


def test_metrics_registries_expose_the_same_text():
    regs = (j_metrics.MetricsRegistry(enabled=True),
            t_metrics.MetricsRegistry(enabled=True))
    for reg in regs:
        c = reg.counter("predictor_dispatch_total", "fused launches")
        c["predict_pool"] += 3
        c["observe_pool"] += 2
        reg.gauge("engine_pressure", "pressure").set(0.25)
        h = reg.histogram("decision_seconds", "wall")
        for v in (0.002, 0.03, 2.0):
            h.observe(v)
    assert regs[0].scrape() == regs[1].scrape()


def test_the_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "assert {'repro_torch.workflow.cluster',\n"
        "        'repro_torch.workflow.journal', 'repro_torch.core.risk',\n"
        "        'repro_torch.core.risk.bands', 'repro_torch.obs.quality',\n"
        "        'repro_torch.obs.risk', 'repro_torch.data.ingest',\n"
        "        'repro_torch.serving.scheduler_service',\n"
        "        'repro_torch.analysis', 'repro_torch.analysis.roofline',\n"
        "        'repro_torch.launch.inputs',\n"
        "        'repro_torch.launch.dryrun'} <= set(mods)\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch import convert
    from repro_torch.baselines import make_method
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lin = (np.eye(2, dtype=np.float32), np.ones((2,), np.float32),
           np.zeros((2,), np.float32))
    params = {"blk": {"w": np.ones((2, 3), np.float32)}}
    for make in (ProvenanceDB, SizeyPredictor, SizeyMethod,
                 lambda: SizeyMethod(device="cuda"),
                 lambda: SizeyMethod(risk=True, quality=True),
                 lambda: make_method("sizey_risk"),
                 lambda: make_method("sizey_risk_temporal"),
                 lambda: convert.state_to_torch("linear", lin),
                 lambda: convert.lm_params_to_torch(params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert SizeyMethod(device="cpu").predictor.device.type == "cpu"
    assert ProvenanceDB(device="cpu").device.type == "cpu"
    assert make_method("sizey_risk_temporal",
                       device="cpu").predictor.device.type == "cpu"
    assert all(t.device.type == "cpu"
               for t in convert.state_to_torch("linear", lin, "cpu"))
    assert convert.lm_params_to_torch(
        params, "cpu")["blk"]["w"].device.type == "cpu"


def test_options_of_later_slices_say_so():
    # the risk slice's options construct, and with them come the engine's
    # hooks of that slice; the legacy per-model loop is built and decides
    from repro_torch.core.config import SizeyConfig
    loop = SizeyPredictor(SizeyConfig(mlp_train_steps=20), fused=False,
                          device="cpu")
    assert not loop.fused
    rng = np.random.default_rng(0)
    for x in rng.uniform(0.5, 8.0, 8):
        d = loop.predict("t", "m", (float(x),), 32.0)
        loop.observe(d, 1.0 + 0.4 * float(x) ** 2, 0.5)
    assert d.source == "model" and d.allocation_gb > 0
    for kw in ({"risk": True}, {"risk": True, "failure_strategy": "auto"},
               {"quality": True}):
        m = SizeyMethod(device="cpu", **kw)
        assert m.quality == kw.get("quality", False)
        assert (m.risk is not None) == bool(kw.get("risk"))
    with pytest.raises(ValueError, match="requires risk"):
        SizeyMethod(device="cpu", failure_strategy="auto")
    # the journal's hooks came with the cluster engine, for either path
    for m in (SizeyMethod(device="cpu"),
              SizeyMethod(device="cpu", temporal_k=4)):
        task = generate_workflow("methylseq", scale=0.05).tasks[0]
        assert m.export_pending(task) is None
        assert m.export_state()["pressure"] == 0.0
        for hook in ("note_clock", "strategy_for", "checkpoint_frac_for"):
            assert callable(getattr(m, hook))


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """The GPU smoke exits non-zero and prints no result line on a machine
    without CUDA, and from a directory that holds only the script."""
    script = SRC.parent / "chip_smoke.py"
    for cwd, path in ((SRC.parent, script), (tmp_path, tmp_path / "s.py")):
        if path != script:
            path.write_text(script.read_text())
        out = subprocess.run([sys.executable, str(path)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_crash_aware_offset_matches_reference():
    """``failure_strategy="checkpoint"``: the offset shrinks with the
    observed crash rate exactly as the reference's adapter shrinks it."""
    from repro.core.predictor import SizingDecision as JDecision
    from repro_torch.core.predictor import SizingDecision
    task = j_generate("methylseq", scale=0.05).tasks[0]
    jm = JMethod(failure_strategy="checkpoint")
    tm = SizeyMethod(failure_strategy="checkpoint", device="cpu")
    args = ("t", "m", (1.0,), "model", 9.0, 4.0, 64.0)
    kw = {"agg_pred_gb": 7.5, "offset_gb": 1.5}
    for m in (jm, tm):
        m._note_completion(task)
        m.note_interruption(task, 0.4)
    a = jm._crash_aware_alloc(JDecision(*args, **kw))
    b = tm._crash_aware_alloc(SizingDecision(*args, **kw))
    assert a == b and 7.5 <= b < 9.0
    assert SizeyMethod(failure_strategy="retry_scaled",
                       device="cpu").failure_strategy == "retry_scaled"
    with pytest.raises(ValueError):
        SizeyMethod(failure_strategy="nope", device="cpu")
