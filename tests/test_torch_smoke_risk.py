"""chip_smoke.py's phase 14 rehearsed on the CPU at a small size: the same
code drives (a) and (b) with their launch, dispatch, row and strategy
checks, (c)'s kill/resume of the chaos cell with its risk and quality
rows, (d)'s service against the engine runs outside it and its crash scan,
and (e)'s card-vs-CPU comparison (the CPU against itself here), with the
kernels' plain versions standing in for the kernels (each call counted as
its launch would be). The card's reference numbers are for scale 1.0, so
the spread checks only print here; the risk layer switches on after two
log rows so that a small trace reprices."""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as m  # noqa: E402

from repro_torch.core.models import knn, mlp  # noqa: E402
from repro_torch.core.temporal import segments  # noqa: E402
from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402


def test_chip_smoke_risk_phase_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(m, "DEV", "cpu")
    # roots an hour apart, so that pools warm up between arrivals
    monkeypatch.setattr(m, "CLUSTER_SCALE", 0.1)
    monkeypatch.setattr(m, "CLUSTER_ARRIVALS", 1.0)
    monkeypatch.setattr(m, "CLUSTER_FAILS", {"fail_rate_per_node_h": 0.2,
                                             "fail_seed": 7})
    monkeypatch.setattr(m, "RISK_CFG", {"min_samples": 2, "window": 64})
    monkeypatch.setattr(m, "RISK_KILLS", 2)
    monkeypatch.setattr(m, "SERVICE_SCALE", 0.05)
    monkeypatch.setattr(m, "_within_spread", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for module, attr, name in ((mlp, "mlp_predict", "ensemble_mlp"),
                               (knn, "knn_predict", "knn_predict"),
                               (segments, "fit_cuts", "segment_dp")):
        fn = getattr(module, attr)

        def counted(*a, _fn=fn, _name=name, **k):
            KERNEL_LAUNCHES[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, attr, counted)
    out = m.risk_phase()
    a, b = out["a"], out["b"]
    assert a["rows"] and b["rows"]
    assert len(a["quality"]) == len(a["trace"].tasks)
    assert set(a["strategies"]) - {"retry_same"}
    assert a["reads"]["reads"] >= 1
    assert b["fits"] >= 1 and b["res"].cluster.n_resizes > 0
    assert out["shapes"]["ensemble_mlp"] and out["shapes"]["knn_predict"]
    assert out["shapes"]["segment_dp"]
