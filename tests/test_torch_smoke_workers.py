"""chip_smoke.py's worker plumbing on the CPU: a phase run in a worker
hands its results and kernel shapes back to the main process, a failed
worker fails its join, and the engine runs' predict dispatches are held
to phase 4's serial count once both are known."""
import io
import json
import pathlib
import sys
from collections import Counter
from contextlib import redirect_stdout

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as m  # noqa: E402

KINDS = ("ensemble_mlp", "knn_predict", "segment_dp")


class _Done:
    """A finished worker whose output is already in ``log``."""

    def __init__(self, log, returncode=0):
        self.log, self.returncode = log, returncode

    def wait(self, timeout=None):
        return self.returncode

    def poll(self):
        return self.returncode


def _run_worker(task, tmp_path):
    """``chip_smoke.py --worker task`` in this process, then joined."""
    settings = json.dumps({k: getattr(m, k) for k in m.WORKER_SETTINGS})
    out = io.StringIO()
    with redirect_stdout(out):
        assert m._worker_main(task, settings) == 0
    log = tmp_path / f"{task}.log"
    log.write_text(out.getvalue())
    got, results = {k: Counter() for k in KINDS}, {}
    with redirect_stdout(io.StringIO()) as printed:
        m._join_worker(task, _Done(log), got, 1, phase=4, results=results)
    assert "RESULT" not in printed.getvalue()
    assert "SHAPES" not in printed.getvalue()
    assert f"[worker] {task} wall" in printed.getvalue()
    return got, results


def test_a_worker_hands_back_its_results_and_shapes(monkeypatch, tmp_path):
    shapes = {"ensemble_mlp": Counter({(1, 1, 1, 32): 2, (1, 128, 1, 32): 1}),
              "knn_predict": Counter({(1, 128, 1): 3}),
              "segment_dp": Counter()}
    main = {"launches": {"ensemble_mlp": 3, "knn_predict": 3}, "tasks": 5,
            "wall_s": 1.0, "shapes": shapes,
            "disp": {"predict_pool": 7, "observe_pool": 1,
                     "refresh_pool": 0}}
    monkeypatch.setattr(m, "main_path", lambda: main)
    monkeypatch.setattr(m, "card_vs_cpu", lambda *a, **k: None)
    _, results = _run_worker("peak", tmp_path)
    back = results["main"]
    assert m._shapes_load(back["shapes"]) == shapes
    assert {k: back[k] for k in ("launches", "disp", "tasks")} == {
        k: main[k] for k in ("launches", "disp", "tasks")}
    # phase 13: its shapes, each run's, and each run's predict dispatches
    # for the bound against phase 4's
    run_a = {"disp": {"predict_pool": 3}, "shapes": shapes}
    run_b = {"disp": {"predict_pool": 4},
             "shapes": {**shapes, "segment_dp": Counter({(5, 32, 4): 2})}}
    monkeypatch.setattr(m, "cluster_phase", lambda: {
        "a": run_a, "b": run_b, "shapes": shapes})
    got, results = _run_worker("cluster_phase", tmp_path)
    assert got == shapes
    assert results["waves"] == [["cluster a", 3], ["cluster b", 4]]
    assert m._shapes_load(results["shapes_b"]) == run_b["shapes"]


def test_the_engine_runs_dispatch_less_than_the_serial_replay():
    m.check_serial([("cluster a", 44), ("risk a", 120)], 926)
    with pytest.raises(AssertionError, match="risk a: 926 predict"):
        m.check_serial([("cluster a", 44), ("risk a", 926)], 926)


def test_a_failed_worker_fails_its_join():
    proc = m._start_worker("paper:999")
    with pytest.raises(AssertionError, match=r"phase 18 paper:999 failed"):
        m._join_worker("paper:999", proc, {k: Counter() for k in KINDS},
                       300, phase=18)
    assert "IndexError" in proc.log.read_text()
