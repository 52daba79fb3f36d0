"""The port's serving engine and KV-cache sizer against the reference's on
the CPU: reduced zamba2-7b with the reference's parameters carried across,
the same numpy-made prompts (lengths 128 and 256, multiples of the SSD
chunk) through both ``ServeEngine``s with ``KVCacheSizer(cap_gb=16.0)``
over 5 batches: completions token for token equal, greedy and at
temperature 0.8 (the Gumbel draws are JAX's threefry bits, reproduced),
equal cache bytes, and the sizer's decisions with equal sources and
``offset_idx`` and allocations within the peak path's 1e-2."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import SizeyConfig as JSizeyConfig
from repro.launch.sizing import KVCacheSizer as JKVCacheSizer
from repro.models import build_model as j_build_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_torch
from repro_torch.core import SizeyConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.sizing import (CPU_CAP_GB, KVCacheSizer,
                                       SizeyJobSizer, device_cap_gb)
from repro_torch.models import build_model
from repro_torch.core import prng, prng_device
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)
ALLOC_RTOL = 1e-2
LENS = (128, 256, 128, 128, 256, 128, 256, 256, 128, 128)


@pytest.fixture(scope="module")
def zamba():
    jcfg = j_get_config("zamba2-7b").reduced()
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("zamba2-7b").reduced())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in LENS]
    return jm, jp, tm, lm_params_to_torch(jax.device_get(jp), "cpu"), prompts


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_reduced_zamba2_serves_the_reference_tokens(zamba, temperature):
    jm, jp, tm, tp, prompts = zamba
    je = JServeEngine(jm, jp, max_batch=2, max_seq=4096,
                      temperature=temperature, seed=3,
                      sizer=JKVCacheSizer(JSizeyConfig(min_history=2),
                                          cap_gb=16.0))
    jout = je.serve([JRequest(i, p, max_new_tokens=8)
                     for i, p in enumerate(prompts)])
    te = ServeEngine(tm, tp, max_batch=2, max_seq=4096,
                     temperature=temperature, seed=3, device="cpu",
                     sizer=KVCacheSizer(SizeyConfig(min_history=2),
                                        cap_gb=16.0, device="cpu"))
    tout = te.serve([Request(i, p, max_new_tokens=8)
                     for i, p in enumerate(prompts)])
    assert [(c.rid, c.prompt_len, c.tokens.tolist()) for c in tout] == \
        [(c.rid, c.prompt_len, c.tokens.tolist()) for c in jout]
    assert te.stats == je.stats and te.stats["batches"] == 5
    jd, td = je.sizer.decisions, te.sizer.decisions
    assert len(td) == len(jd) == 5
    assert [d.source for d in td] == [d.source for d in jd]
    assert [d.offset_idx for d in td] == [d.offset_idx for d in jd]
    assert sum(d.source == "model" for d in td) == 3
    for a, b in zip(td, jd):
        assert abs(a.allocation_gb - b.allocation_gb) \
            <= ALLOC_RTOL * abs(b.allocation_gb)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gumbel_draws_are_jax_bits(seed):
    key = prng.split(prng.prng_key(seed))[1]
    jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.gumbel(jkey, (8, 4096)))
    got = prng_device.gumbel(key, (8, 4096), "cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the host draws of core.prng give the same bits
    u = prng.uniform(key, (8, 4096), prng_device.F32_TINY, 1.0)
    assert np.array_equal(-prng.log_f32(-prng.log_f32(u)), want)
    logits = np.random.default_rng(seed).standard_normal((8, 4096)) \
        .astype(np.float32)
    cat = np.asarray(jax.random.categorical(jkey, logits / 0.8))
    assert np.array_equal(torch.argmax(got + torch.from_numpy(logits) / 0.8,
                                       -1).numpy(), cat)


def test_device_log_is_the_host_log_over_every_exponent():
    """``prng_device.log_f32`` is ``prng.log_f32`` bit for bit, from the
    smallest normal float32 to the largest."""
    x = np.random.default_rng(0).uniform(1.0, 2.0, 1 << 16).astype(np.float32)
    x = (x[None, :] * np.exp2(np.arange(-126, 128, 9.0))[:, None]) \
        .astype(np.float32).ravel()
    x = np.concatenate([x, np.float32([1.0, 0.5, 0.7071068, 1e-38])])
    assert np.array_equal(prng_device.log_f32(torch.from_numpy(x)).numpy(),
                          prng.log_f32(x))


def test_serve_cli_runs_on_the_cpu():
    engine = serve_cli.main(["--arch", "zamba2-7b", "--requests", "3",
                             "--max-new", "3", "--device", "cpu"])
    assert engine.stats["requests"] == 3 and engine.stats["tokens"] == 9


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    for make in (lambda: model.init(0), lambda: model.init_cache(1, 8),
                 lambda: ServeEngine(model, params), KVCacheSizer,
                 SizeyJobSizer, lambda: serve_cli.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert KVCacheSizer(device="cpu").predictor.device.type == "cpu"
    assert device_cap_gb("cpu") == CPU_CAP_GB == 16.0


def test_engine_refuses_parameters_on_another_device():
    cfg = get_config("zamba2-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    params = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
              for k, v in params.items()}
    with pytest.raises(ValueError, match="parameters on"):
        ServeEngine(model, params, device="cpu")


def test_serve_cli_module_runs_as_a_script():
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-2b", "--requests", "2", "--max-new", "2", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "2 completions, 4 tokens" in out.stdout
