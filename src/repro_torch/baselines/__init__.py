"""Sizing methods behind the SizingMethod protocol. The slice holds the
Sizey adapter; the paper's baselines (Witt, Tovar PPM, presets, KS+) come
later (ROADMAP.md, Queue 1)."""
from repro_torch.baselines.sizey_method import SizeyMethod
