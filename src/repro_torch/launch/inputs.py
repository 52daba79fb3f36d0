"""Fake-tensor stand-ins for every model input (dry-run pattern).

The reference's ``repro/launch/inputs.py``. ``input_specs(cfg, shape)``
returns (step_kind, batch tree):

  * train   -> the train_step batch {tokens[, patch_embeds]}
  * prefill -> the prefill batch (same contents; labels come from shifting
               inside the loss)
  * decode  -> {"tokens": (B, 1)} + the KV/SSM cache tree for seq_len
               context (``decode_*``/``long_*`` trace the decode step, not
               the train step)

Every leaf is a fake tensor (``torch._subclasses.FakeTensor``) with the
reference's ShapeDtypeStruct's shape and dtype: it carries shape, dtype
and device and is never allocated. They belong to the fake mode active
where they are made, or to a fresh one. The decode cache is the port's
``init_cache`` run under that mode.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_cache


@contextlib.contextmanager
def _fake():
    """Under the active ``FakeTensorMode``, or a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        yield
    else:
        with FakeTensorMode():
            yield


def token_batch_spec(cfg: ModelConfig, batch: int, seq: int, *,
                     device="cuda") -> dict:
    """Token (+ stub-frontend) inputs for a full-sequence step."""
    spec = {}
    with _fake():
        if cfg.family == "vlm":
            # the InternViT frontend is a stub: precomputed patch
            # embeddings occupy the first n_patches positions of the
            # sequence budget
            text = seq - cfg.n_patches
            spec["patch_embeds"] = torch.empty(
                (batch, cfg.n_patches, cfg.d_model),
                dtype=dtype_of(cfg.compute_dtype), device=device)
            spec["tokens"] = torch.empty((batch, text), dtype=torch.int32,
                                         device=device)
        else:
            spec["tokens"] = torch.empty((batch, seq), dtype=torch.int32,
                                         device=device)
    return spec


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda"):
    with _fake():
        return init_cache(cfg, batch, max_seq, device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, device="cuda"):
    """(step_kind, fake batch tree) for one (arch x shape) cell."""
    with _fake():
        if shape.kind == "train":
            return "train", token_batch_spec(cfg, shape.global_batch,
                                             shape.seq_len, device=device)
        if shape.kind == "prefill":
            return "prefill", token_batch_spec(cfg, shape.global_batch,
                                               shape.seq_len, device=device)
        if shape.kind == "decode":
            return "decode", {
                "tokens": torch.empty((shape.global_batch, 1),
                                      dtype=torch.int32, device=device),
                "cache": cache_spec(cfg, shape.global_batch, shape.seq_len,
                                    device=device),
            }
    raise ValueError(shape.kind)
