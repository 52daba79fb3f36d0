"""The port's baselines against the reference's, on the CPU.

The numpy baselines (Witt x3, Tovar PPM, presets) are copies, and KS+ is
numpy apart from its boundary fits, which the port runs through the
segment-DP kernel's plain version with the reference oracle's cut
indices: so a replay gives a ``SimResult`` equal to the reference's field
for field, on every workflow.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.baselines import ALL_BASELINES as J_ALL  # noqa: E402
from repro.baselines import make_method as j_make  # noqa: E402
from repro.workflow import WORKFLOWS as J_WORKFLOWS  # noqa: E402
from repro.workflow import generate_workflow as j_generate  # noqa: E402
from repro.workflow import simulate as j_simulate  # noqa: E402
from repro_torch.baselines import (ALL_BASELINES, KSPlusMethod,  # noqa: E402
                                   SizeyMethod, make_method)
from repro_torch.workflow import generate_workflow, simulate  # noqa: E402


def _as_plain(obj):
    """A SimResult as nested plain values (dataclasses of either package
    compare equal when their fields do)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _as_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_as_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _as_plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _replay_both(name, workflow, scale, **kw):
    rj = j_simulate(j_generate(workflow, scale=scale), j_make(name, **kw))
    rt = simulate(generate_workflow(workflow, scale=scale),
                  make_method(name, **kw, **(
                      {"device": "cpu"} if name == "ks_plus" else {})))
    return rj, rt


@pytest.mark.parametrize("workflow", sorted(J_WORKFLOWS))
@pytest.mark.parametrize("name", sorted(J_ALL))
def test_baseline_replays_equal_the_reference(name, workflow):
    assert ALL_BASELINES == J_ALL
    rj, rt = _replay_both(name, workflow, 0.05)
    assert len(rt.outcomes) > 0
    assert _as_plain(rt) == _as_plain(rj)


@pytest.mark.parametrize("strategy", ["retry_scaled", "checkpoint"])
def test_ks_plus_fits_its_pools_and_equals_the_reference(strategy):
    """methylseq at scale 0.3: every KS+ pool passes min_history and fits
    its boundaries many times over."""
    fits = []
    fit = KSPlusMethod._segments_for

    def counting(self, key):
        fits.append(key)
        return fit(self, key)

    KSPlusMethod._segments_for = counting
    try:
        rj, rt = _replay_both("ks_plus", "methylseq", 0.3,
                              failure_strategy=strategy)
    finally:
        KSPlusMethod._segments_for = fit
    assert len(set(fits)) >= 8 and len(fits) > 200
    assert _as_plain(rt) == _as_plain(rj)


def test_make_method_names_and_devices(monkeypatch):
    sizey = ("sizey", "sizey_argmax", "sizey_temporal", "sizey_risk",
             "sizey_risk_temporal")
    for name in ALL_BASELINES + sizey:
        m = make_method(name, device="cpu")
        assert m.name == name
    assert make_method("sizey_temporal", device="cpu",
                       k_segments=3).predictor.k == 3
    assert make_method("sizey_risk_temporal", device="cpu",
                       k_segments=3).predictor.k == 3
    assert make_method("witt_lr", failure_strategy="checkpoint"
                       ).failure_strategy == "checkpoint"
    assert make_method("sizey_risk", device="cpu", failure_strategy="auto"
                       ).failure_strategy == "auto"
    with pytest.raises(ValueError):
        make_method("sizey", device="cpu", failure_strategy="auto")
    with pytest.raises(ValueError):
        make_method("nope")
    with pytest.raises(ValueError):
        make_method("witt_lr", failure_strategy="nope")
    # the methods that use the card raise without one unless asked for the
    # CPU; the numpy baselines take no device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sizey + ("ks_plus",):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_method(name)
    for name in ("witt_wastage", "witt_lr", "witt_percentile", "tovar_ppm",
                 "workflow_presets"):
        make_method(name)
    assert isinstance(make_method("sizey", device="cpu"), SizeyMethod)
