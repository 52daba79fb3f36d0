"""chip_smoke.py's LM phases (8-12) rehearsed on the CPU at the reduced
zamba2-7b config: the same code drives the serve, the launch-count and
cache-size checks, the teacher-forced and card-vs-CPU comparisons and the
JSON rows, with the kernels' plain versions standing in for the kernels
(each call counted as its launch would be) and no device timing."""
import dataclasses
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.models import knn, mlp  # noqa: E402
from repro_torch.kernels import KERNEL_LAUNCHES  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _counting(monkeypatch, module, attr, name):
    """Count each call as its launch would be counted (K5 on an e4m3
    cache under its own name)."""
    fn = getattr(module, attr)

    def counted(*a, **k):
        fp8 = name == "flash_decode" and a[1].dtype == torch.float8_e4m3fn
        KERNEL_LAUNCHES[name + "_fp8" if fp8 else name] += 1
        return fn(*a, **k)
    monkeypatch.setattr(module, attr, counted)


def test_lm_phases_run_on_the_cpu_with_plain_kernels(monkeypatch):
    torch.set_num_threads(1)
    red = get_config("zamba2-7b").reduced()
    m = chip_smoke
    monkeypatch.setattr(m, "DEV", "cpu")
    monkeypatch.setattr(m, "serve_config", lambda: dataclasses.replace(
        red, compute_dtype="bfloat16"))
    monkeypatch.setattr(m, "cvc_config", lambda: red)
    monkeypatch.setattr(m, "SERVE_LENS", (128, 256))
    monkeypatch.setattr(m, "SERVE_NEW", 3)
    monkeypatch.setattr(m, "TF_LEN", 128)
    monkeypatch.setattr(m, "CVC_LEN", 128)
    monkeypatch.setattr(m, "K4_SHAPES", m.K4_SHAPES[:1])
    monkeypatch.setattr(m, "K5_SHAPES", m.K5_SHAPES[:1])
    monkeypatch.setattr(m, "K6_SHAPES", m.K6_SHAPES[:1])
    monkeypatch.setattr(m, "_time_ms", lambda fn, *a: (fn(), 1.0)[1])
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for module, attr, name in (
            (attention, "flash_attention", "flash_attention"),
            (attention, "flash_decode", "flash_decode"),
            (ssm, "ssd_scan", "ssd_scan"),
            (mlp, "mlp_predict", "ensemble_mlp"),
            (knn, "knn_predict", "knn_predict")):
        _counting(monkeypatch, module, attr, name)
    rows, time_rows = m.lm_phases()
    time_rows()
    assert [r["name"] for r in rows] == ["flash_attention", "flash_decode",
                                         "flash_decode_fp8",
                                         "flash_decode_lse", "ssd_scan"]
    # 4 batches of 8 with 2 steps each: 2 shared-block applications and 2
    # Mamba2 layers per prefill, 2 attention layers per decode step; the
    # e4m3 serve's 8 steps; the log-sum-exp variant's come from phase 16
    assert [r["launches"] for r in rows] == [8, 16, 16, 0, 8]
    for r in rows:
        assert set(r) == KEYS and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations")
    # the e4m3 cache halves the bytes of K5's bound
    assert rows[2]["bound_ms"] < 0.6 * rows[1]["bound_ms"]
    assert rows[4]["library_ms"] is None
