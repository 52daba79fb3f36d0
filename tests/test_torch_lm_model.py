"""The port's LM models against the reference's on the CPU: reduced
granite-3-2b (dense GQA), mamba2-780m (SSM) and zamba2-7b (hybrid) with the
reference's parameters carried across by ``convert.lm_params_to_torch``,
the same numpy-made tokens through both: forward logits, prefill logits
and the decode cache leaf by leaf, then 8 decode steps. Tolerance 1e-4
(atol = rtol) on logits and cache leaves: the reduced configs compute in
fp32, where the port's kernels' plain versions and the reference's jnp
paths differ by summation order only (measured below 1e-6). Plus the
port's own decode-matches-forward, after tests/test_arch_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.utils.misc import tree_bytes as j_tree_bytes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_to_numpy, lm_params_to_torch
from repro_torch.models import build_model, cast_weights
from repro_torch.models.model import init_cache
from repro_torch.models.ssm import ssm_block
from repro_torch.utils.misc import tree_bytes

torch.set_num_threads(1)
TOL = 1e-4
ARCHS = ("granite-3-2b", "mamba2-780m", "zamba2-7b")


def _pair(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tm, lm_params_to_torch(jax.device_get(jp), "cpu")


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, err_msg=what)


def _cmp_tree(j_tree, t_tree, path=""):
    assert set(j_tree) == set(t_tree), path
    for k in j_tree:
        if isinstance(j_tree[k], dict):
            _cmp_tree(j_tree[k], t_tree[k], f"{path}/{k}")
        else:
            a = np.asarray(j_tree[k])
            assert a.shape == t_tree[k].shape and a.dtype == t_tree[k].dtype
            _close(t_tree[k], a, f"{path}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_the_reference(arch):
    jcfg, jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "forward")
    _close(tm.loss(tp, {"tokens": torch.from_numpy(toks)}),
           jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(toks)}), "loss")

    jpl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=16))(
        jp, {"tokens": jnp.asarray(toks[:, :8])})
    tpl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])},
                             max_seq=16)
    _close(tpl, jpl, "prefill")
    _cmp_tree(jax.device_get(jcache), lm_params_to_numpy(tcache))
    assert tree_bytes(tcache) == j_tree_bytes(jcache)

    decode = jax.jit(jm.decode_step)
    for t in range(8, 16):
        jd, jcache = decode(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        td, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]))
        _close(td, jd, f"decode pos {t}")
    _cmp_tree(jax.device_get(jcache), lm_params_to_numpy(tcache))


@pytest.mark.parametrize("arch", ARCHS + ("musicgen-large",))
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the full-sequence forward (the
    reference's tolerance, tests/test_arch_smoke.py)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    s, pre = 16, 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, s)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    logits, cache = model.prefill(params, {"tokens": toks[:, :pre]},
                                  max_seq=s)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, pre - 1].numpy(), rtol=2e-3, atol=2e-3)
    for t in range(pre, s):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{arch} decode pos {t}")
    assert int(cache["pos"]) == s


def test_casting_the_weights_once_is_bitwise_casting_at_each_use():
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    cast = cast_weights(params, cfg)
    assert cast["mamba"]["ssm"]["in_proj"].dtype == torch.bfloat16
    assert cast["mamba"]["ssm"]["a_log"].dtype == torch.float32
    assert cast["shared"]["ln1"] is params["shared"]["ln1"]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    a, ca = model.prefill(params, {"tokens": toks}, max_seq=40)
    b, cb = model.prefill(cast, {"tokens": toks}, max_seq=40)
    assert torch.equal(a, b)
    for _ in range(3):
        tok = a[:, -1].argmax(-1)[:, None]
        a, ca = model.decode_step(params, ca, tok)
        b, cb = model.decode_step(cast, cb, tok)
        assert torch.equal(a, b)


def test_params_round_trip_and_shapes_match_the_reference():
    jcfg, jm, jp, tm, tp = _pair("zamba2-7b")
    back = lm_params_to_numpy(tp)
    jnp_tree = jax.device_get(jp)

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert np.array_equal(np.asarray(a[k]), b[k])
    same(jnp_tree, back)
    # the port's own initialisation has the reference's tree
    own = tm.init(0, device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in t.items()}
    assert shapes(own) == shapes(tp)
    j_full = j_get_config("zamba2-7b")
    assert get_config("zamba2-7b").param_count() == j_full.param_count() \
        == 4_646_967_008


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(j_get_config(arch).reduced())


def test_cache_bytes_at_full_width_are_the_reference_layout():
    """zamba2-7b's cache for 8 slots x 2,080 positions, counted from the
    port's cache layout on the meta device: 6.75 GiB."""
    cfg = get_config("zamba2-7b")
    cache = init_cache(cfg, 8, 2080, "meta")
    n = tree_bytes(cache)
    assert n == 7_252_512_772
    assert round(n / 1024**3, 2) == 6.75


def test_the_hybrid_prefill_keeps_the_chunk_contract():
    cfg = get_config("zamba2-7b").reduced()
    params = build_model(cfg).init(0, device="cpu")["mamba"]
    layer = {k: v[0] for k, v in params["ssm"].items()}
    with pytest.raises(ValueError, match="chunk"):
        ssm_block(layer, torch.zeros((1, 200, cfg.d_model)), cfg)
