"""State-of-the-art baselines (paper §III-B) + the Sizey adapter, as in
the reference's ``repro.baselines``.

All methods implement the SizingMethod protocol of
:mod:`repro_torch.workflow.simulator`. The numpy baselines (Witt x3, Tovar
PPM, presets) are copies of the reference's; KS+ and the Sizey methods run
on a device (CUDA unless the caller asks for another).
"""
from repro_torch.baselines.common import HistoryMethod
from repro_torch.baselines.ks_plus import KSPlusMethod
from repro_torch.baselines.presets import WorkflowPresets
from repro_torch.baselines.sizey_method import SizeyMethod
from repro_torch.baselines.tovar_ppm import TovarPPM
from repro_torch.baselines.witt import WittLR, WittPercentile, WittWastage

ALL_BASELINES = ("witt_wastage", "witt_lr", "tovar_ppm", "witt_percentile",
                 "workflow_presets", "ks_plus")


def make_method(name: str, machine_cap_gb: float = 128.0, ttf: float = 1.0,
                failure_strategy: str | None = None, device=None, **kw):
    """Factory used by benchmarks: name -> SizingMethod instance.

    ``failure_strategy`` (``retry_same`` / ``retry_scaled`` /
    ``checkpoint``, plus ``auto`` for the risk variants) sets the crash
    handling the engines apply to the method's attempts. ``device`` goes to
    the methods that use the card (every ``sizey*`` and ``ks_plus``); the
    numpy baselines take none. ``sizey_risk`` / ``sizey_risk_temporal`` are
    the risk-priced variants (a ``risk`` kwarg forwards a
    :class:`~repro_torch.core.risk.RiskConfig`; defaults otherwise).
    """
    from repro_torch.core import SizeyConfig

    # validation lives in the constructors: the factory only forwards
    strat = ({} if failure_strategy is None
             else {"failure_strategy": failure_strategy})
    if name == "sizey":
        return SizeyMethod(SizeyConfig(**kw), ttf=ttf,
                           machine_cap_gb=machine_cap_gb, device=device,
                           **strat)
    if name == "sizey_risk":
        risk = kw.pop("risk", True)
        return SizeyMethod(SizeyConfig(**kw), ttf=ttf,
                           machine_cap_gb=machine_cap_gb, name="sizey_risk",
                           risk=risk, device=device, **strat)
    if name == "sizey_risk_temporal":
        risk = kw.pop("risk", True)
        k = kw.pop("k_segments", 4)
        return SizeyMethod(SizeyConfig(**kw), ttf=ttf,
                           machine_cap_gb=machine_cap_gb,
                           name="sizey_risk_temporal", temporal_k=k,
                           risk=risk, device=device, **strat)
    if name == "sizey_argmax":
        return SizeyMethod(SizeyConfig(strategy="argmax", **kw), ttf=ttf,
                           machine_cap_gb=machine_cap_gb, name="sizey_argmax",
                           device=device, **strat)
    if name == "sizey_temporal":
        k = kw.pop("k_segments", 4)
        return SizeyMethod(SizeyConfig(**kw), ttf=ttf,
                           machine_cap_gb=machine_cap_gb, temporal_k=k,
                           device=device, **strat)
    if name == "ks_plus":
        return KSPlusMethod(machine_cap_gb, device=device, **strat, **kw)
    if name == "witt_wastage":
        return WittWastage(machine_cap_gb, ttf=ttf, **strat)
    if name == "witt_lr":
        return WittLR(machine_cap_gb, **strat)
    if name == "witt_percentile":
        return WittPercentile(machine_cap_gb, **strat)
    if name == "tovar_ppm":
        return TovarPPM(machine_cap_gb, ttf=ttf, **strat)
    if name == "workflow_presets":
        return WorkflowPresets(machine_cap_gb, **strat)
    raise ValueError(f"unknown method {name!r}")
