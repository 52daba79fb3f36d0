"""The port's ``moe`` and ``vlm`` families against the reference's on the
CPU: the router's top-k on ties, the three MoE dispatch modes (outputs,
aux loss and the tokens dropped at capacity), the MoE and VLM models'
forward, loss, prefill and decode, and decode against forward with no
token dropped (``capacity_factor = n_experts``, as
tests/test_arch_smoke.py). Inputs from numpy seeds, the reference's
parameters carried across by ``convert.lm_params_to_torch``. Tolerance:
1e-5 of the largest |value| (fp32; summation order in the products), the
integer outputs (top-k indices, dropped tokens) equal; decode against
forward at the reference's 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_numpy, lm_params_to_torch
from repro_torch.models import build_model
from repro_torch.models import moe

torch.set_num_threads(1)
TOL = 1e-5
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


def _moe_pair(arch, **replace):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **replace)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    return jcfg, tcfg


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def test_router_top_k_breaks_ties_as_jax():
    """Equal router probabilities: the lowest expert index first."""
    jcfg, tcfg = _moe_pair("phi3.5-moe-42b-a6.6b", top_k=3)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, (jcfg.d_model, jcfg.n_experts)).astype(np.float32)
    # columns 0, 2 and 3 equal: ties at every token
    w[:, 2] = w[:, 0]
    w[:, 3] = w[:, 0]
    x[:4] = 0.0               # all four experts equal for these tokens
    ji, jw, ja = j_moe.router({"w_router": jnp.asarray(w)},
                              jnp.asarray(x), jcfg)
    ti, tw, ta = moe.router({"w_router": torch.from_numpy(w)},
                            torch.from_numpy(x), tcfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [0, 1, 2]
    _close(tw, jw, "weights")
    _close(ta, ja, "aux")


@pytest.mark.parametrize("dispatch", ["grouped", "flat", "rowwise"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dispatch_modes_match_the_reference(dispatch, cf):
    jcfg, tcfg = _moe_pair("phi3.5-moe-42b-a6.6b", moe_dispatch=dispatch,
                           capacity_factor=cf)
    jp = jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(1)))
    jl = _layer0(jp["blocks"]["moe"])
    tl = lm_params_to_torch(jl, "cpu")
    x = np.random.default_rng(2).normal(0, 1, (3, 20, jcfg.d_model)) \
        .astype(np.float32)
    jy, jaux = j_moe.moe_block(jl, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_block(tl, torch.from_numpy(x), tcfg)
    _close(ty, jy, f"{dispatch} y")
    _close(taux, jaux, f"{dispatch} aux")
    # the tokens dropped from every slot have a zero output row
    t_drop = (ty.abs().sum(-1) == 0).numpy()
    j_drop = np.asarray(jnp.abs(jy).sum(-1) == 0)
    assert np.array_equal(t_drop, j_drop)
    if cf < 1:
        assert t_drop.any()
    if dispatch != "grouped":
        ti, _, _ = moe.router(tl, torch.from_numpy(x).reshape(60, -1), tcfg)
        ji, _, _ = j_moe.router(jl, jnp.asarray(x).reshape(60, -1), jcfg)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        e, k = tcfg.n_experts, tcfg.top_k
        tpos = moe._positions_flat(ti.reshape(-1), e) if dispatch == "flat" \
            else moe._positions_rowwise(ti, 3, 20, e, k)
        jpos = j_moe._positions_flat(ji.reshape(-1), e) \
            if dispatch == "flat" else j_moe._positions_rowwise(ji, 3, 20,
                                                                e, k)
        assert np.array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("arch", MOE_ARCHS + ("internvl2-26b",))
def test_forward_prefill_and_decode_match_the_reference(arch):
    jcfg, tcfg = _moe_pair(arch)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_to_torch(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(3)
    n_front = jcfg.n_patches if jcfg.family == "vlm" else 0
    toks = rng.integers(0, jcfg.vocab, (2, 16 - n_front)).astype(np.int32)
    batch = {"tokens": toks}
    if n_front:
        batch["patch_embeds"] = rng.normal(
            0, 1, (2, n_front, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    tl, taux = tm.forward(tp, tb)
    _close(tl, jl, "forward")
    _close(taux, jaux, "aux")
    _close(tm.loss(tp, tb), jax.jit(jm.loss)(jp, jb), "loss")

    pre = 8 - n_front
    jpb = {**jb, "tokens": jb["tokens"][:, :pre]}
    tpb = {**tb, "tokens": tb["tokens"][:, :pre]}
    jpl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=16))(jp, jpb)
    tpl, tc = tm.prefill(tp, tpb, max_seq=16)
    _close(tpl, jpl, "prefill")
    jc_np = jax.device_get(jc)
    for k in ("k", "v"):
        _close(tc[k], jc_np[k], f"cache {k}")
    decode = jax.jit(jm.decode_step)
    for t in range(pre, 16 - n_front):
        jd, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        td, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(td, jd, f"decode {t}")
    assert int(tc["pos"]) == 16


@pytest.mark.parametrize("arch", MOE_ARCHS + ("internvl2-26b",))
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the forward (no token dropped)."""
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    n_front = cfg.n_patches if cfg.family == "vlm" else 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16 - n_front))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if n_front:
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (2, n_front, cfg.d_model)).astype(np.float32))
    full, _ = model.forward(params, batch)
    logits, cache = model.prefill(
        params, {**batch, "tokens": toks[:, :8 - n_front]}, max_seq=16)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 7].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(8, 16):
        logits, cache = model.decode_step(
            params, cache, toks[:, t - n_front:t - n_front + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{arch} decode pos {t}")


def test_vlm_loss_is_on_the_text_positions_only():
    jcfg, tcfg = _moe_pair("internvl2-26b")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    tp = lm_params_to_torch(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    pe = rng.normal(0, 1, (2, jcfg.n_patches, jcfg.d_model)).astype(
        np.float32)
    tb = {"tokens": torch.from_numpy(toks), "patch_embeds":
          torch.from_numpy(pe)}
    jb = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)}
    _close(tm.loss(tp, tb), jm.loss(jp, jb), "loss")
    # other patches move the loss; the logits at the patch positions
    # before the last one do not enter it
    pe2 = pe.copy()
    pe2[:, -1] += 1.0
    tb2 = dict(tb, patch_embeds=torch.from_numpy(pe2))
    assert float(tm.loss(tp, tb2)) != float(tm.loss(tp, tb))
    logits, _ = tm.forward(tp, tb)
    assert logits.shape[1] == jcfg.n_patches + 12


def test_moe_param_tree_is_the_reference_tree():
    jcfg, tcfg = _moe_pair("phi3.5-moe-42b-a6.6b")
    jp = jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    own = build_model(tcfg).init(0, device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(np.shape(v)), str(np.asarray(v).dtype)
                 if not isinstance(v, torch.Tensor)
                 else str(v.dtype).split(".")[-1]) for k, v in t.items()}
    assert shapes(own) == shapes(jp)
    assert shapes(lm_params_to_numpy(own)) == shapes(jp)
