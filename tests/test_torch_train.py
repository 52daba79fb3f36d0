"""The port's training slice against the reference's on the CPU: the data
pipeline, the optimizers, int8 gradient compression, checkpoints, the
train step, the trainer with its restart and OOM ladder, and a forward
and gradient step of every architecture.

Inputs are made from seeds with numpy (or carried across with
``convert``); tolerances:
  * pipeline batches, int8 gradients, checkpoint files (``meta.json``
    byte for byte, arrays bit for bit), straggler events, the ladder's
    allocations: equal;
  * optimizer updates over 5 steps: 1e-6 (atol = rtol; the same fp32
    operations, apart from XLA's and PyTorch's ``pow`` and ``rsqrt``,
    measured below 1e-7);
  * losses, gradient norms and gradients of the reduced models (fp32
    compute): 1e-5 relative to the largest |value| (summation order in
    the products; measured below 3e-6);
  * parameters after one AdamW step: 0.05 x lr, or 2 x lr where the step
    quantizes its gradients. Adam's first update of a weight is
    g / (|g| + eps): a gradient element near eps turns a 1e-6 relative
    difference into a visible one (1.3e-2 x lr measured), and a gradient
    that rounds to another int8 step in one package flips the update.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.launch import train as j_launch
from repro.models import build_model as j_build_model
from repro.train import checkpoint as j_ckpt
from repro.train import compression as j_comp
from repro.train import optimizer as j_opt
from repro.train.loop import StragglerMonitor as JMonitor
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (lm_params_to_torch, opt_state_to_numpy,
                                 opt_state_to_torch)
from repro_torch.core import prng
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import train as t_launch
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod
from repro_torch.train.loop import (SimulatedOOM, StragglerMonitor, Trainer,
                                    TrainerConfig)
from repro_torch.train.step import make_train_step
from repro_torch.utils.misc import tree_flatten_with_path, tree_map

torch.set_num_threads(1)
OPT_TOL = 1e-6
TOL = 1e-5
ARCH = "granite-3-2b"


def _np_tree(rng, like):
    return {k: _np_tree(rng, v) if isinstance(v, dict)
            else rng.normal(0, 1, np.shape(v)).astype(np.float32)
            for k, v in like.items()}


def _close_tree(got, want, tol, what=""):
    """``got`` (tensors or numpy) against ``want`` (numpy), leaf by leaf,
    within ``tol`` of each leaf's largest |value|."""
    pg, lg = tree_flatten_with_path(got)
    pw, lw = tree_flatten_with_path(want)
    assert pg == pw, what
    for p, a, b in zip(pg, lg, lw):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        assert a.shape == b.shape, (what, p)
        scale = max(float(np.max(np.abs(b))), 1.0) if b.size else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {p}")


def _reduced(arch=ARCH):
    return j_get_config(arch).reduced(), get_config(arch).reduced()


def _j_params(jcfg, seed=0):
    return jax.device_get(j_build_model(jcfg).init(jax.random.PRNGKey(seed)))


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,hosts,host", [(0, 1, 0), (7, 2, 1),
                                             (123, 4, 2)])
def test_pipeline_batches_are_the_reference_bitwise(seed, hosts, host):
    args = (1000, 48, 8)
    kw = dict(n_hosts=hosts, host_id=host, seed=seed, name="granite")
    a, b = SyntheticTokenPipeline(*args, **kw), JPipeline(*args, **kw)
    for s in (0, 1, 17, 300):
        x, y = a.batch_at(s), b.batch_at(s)
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
        assert np.array_equal(a.batch_at(s, host_id=0),
                              b.batch_at(s, host_id=0))


def test_pipeline_prefetch_order_is_the_reference_bitwise():
    a, b = SyntheticTokenPipeline(100, 16, 2, seed=3), \
        JPipeline(100, 16, 2, seed=3)
    a.start(from_step=5)
    b.start(from_step=5)
    for _ in range(6):
        sa, xa = a.next()
        sb, xb = b.next()
        assert sa == sb and np.array_equal(xa, xb)
    a.stop()
    b.stop()
    # without the thread, next() walks the steps in order too
    c = SyntheticTokenPipeline(100, 16, 2, seed=3)
    assert [c.next()[0] for _ in range(3)] == [0, 1, 2]


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_the_reference_over_5_steps(name):
    rng = np.random.default_rng(11)
    like = {"w": np.zeros((3, 6, 5)), "b": {"v": np.zeros((7,)),
                                           "m": np.zeros((4, 9))},
            "s": np.zeros((1, 5))}
    p0 = _np_tree(rng, like)
    jo, to = j_opt.make_optimizer(name, lr=1e-2), opt.make_optimizer(
        name, lr=1e-2)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = lm_params_to_torch(p0, "cpu")
    ts = to.init(tp)
    _close_tree(opt_state_to_numpy(ts), jax.device_get(js), 0, "init")
    for _ in range(5):
        g = _np_tree(rng, like)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(lm_params_to_torch(g, "cpu"), ts, tp)
    _close_tree(tp, jax.device_get(jp), OPT_TOL, "params")
    _close_tree(opt_state_to_numpy(ts), jax.device_get(js), OPT_TOL,
                "state")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 5


def test_opt_state_round_trips_through_convert():
    jcfg, _ = _reduced()
    jp = _j_params(jcfg)
    for name in ("adamw", "adafactor"):
        js = jax.device_get(j_opt.make_optimizer(name).init(jp))
        back = opt_state_to_numpy(opt_state_to_torch(js, "cpu"))
        _close_tree(back, js, 0, name)
        assert back["step"].dtype == np.int32


# ----------------------------------------------------------- compression
def test_fold_in_and_split_are_jax_bitwise():
    for seed, data in [(0, 0), (3, 17), (11, -5), (2**31 - 1, 2**31 - 1)]:
        k = prng.prng_key(seed)
        assert np.array_equal(prng.fold_in(k, data), np.asarray(
            jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(data))))


@pytest.mark.parametrize("seed", [0, 5])
def test_int8_quantization_is_the_reference_bitwise(seed):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(0, 1, (33, 17)).astype(np.float32),
         "a": {"b": rng.normal(0, 1e-3, (5,)).astype(np.float32),
               "c": np.zeros((4, 4), np.float32)}}
    jq, js = j_comp.quantize_int8(jax.tree.map(jnp.asarray, g),
                                  jax.random.PRNGKey(seed))
    tq, ts = comp.quantize_int8(lm_params_to_torch(g, "cpu"),
                                prng.prng_key(seed))
    for a, b in zip(tree_flatten_with_path(tq)[1],
                    jax.tree_util.tree_leaves(jq)):
        assert a.dtype == torch.int8 and np.array_equal(a.numpy(),
                                                        np.asarray(b))
    _close_tree(ts, jax.device_get(js), 0, "scales")
    _close_tree(comp.dequantize_int8(tq, ts),
                jax.device_get(j_comp.dequantize_int8(jq, js)), 0, "deq")
    # the compressor hook and the one-device compressed sum
    _close_tree(comp.make_compressor(seed)(lm_params_to_torch(g, "cpu")),
                jax.device_get(j_comp.make_compressor(seed)(
                    jax.tree.map(jnp.asarray, g))), 0, "compressor")
    key = jax.random.PRNGKey(seed + 1)
    jsum = jax.vmap(lambda t: j_comp.compressed_psum(t, "i", key),
                    axis_name="i")(jax.tree.map(lambda a: a[None], g))
    _close_tree(comp.compressed_psum(lm_params_to_torch(g, "cpu"), "i",
                                     prng.prng_key(seed + 1)),
                jax.tree.map(lambda a: np.asarray(a)[0], jsum), 0, "psum")


def test_int8_quantization_is_unbiased():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (64, 64)).astype(np.float32))}
    acc = torch.zeros(64, 64)
    for i in range(64):
        q, s = comp.quantize_int8(g, prng.prng_key(i))
        acc += comp.dequantize_int8(q, s)["w"]
    assert float((acc / 64 - g["w"]).abs().max()) < 0.05


# ----------------------------------------------------------- checkpoints
def _ckpt_tree(rng):
    return {"params": {"blocks": {"wq": rng.normal(0, 1, (2, 3, 4)).astype(
        np.float32)}, "embed": rng.normal(0, 1, (5, 3)).astype(np.float32)},
        "opt": {"step": np.asarray(3, np.int32),
                "m": {"a": rng.normal(0, 1, (6,)).astype(np.float32)}}}


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(2))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.save(jdir, 7, jax.tree.map(jnp.asarray, tree))
    ckpt.save(tdir, 7, lm_params_to_torch(tree, "cpu"))
    for name in ("meta.json",):
        with open(os.path.join(jdir, "step_00000007", name), "rb") as f, \
                open(os.path.join(tdir, "step_00000007", name), "rb") as g:
            assert f.read() == g.read()
    a = np.load(os.path.join(jdir, "step_00000007", "shard_0.npz"))
    b = np.load(os.path.join(tdir, "step_00000007", "shard_0.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    meta = json.load(open(os.path.join(tdir, "step_00000007", "meta.json")))
    assert meta["paths"][0] == "['opt']/['m']/['a']"
    # the port restores the reference's files, the reference the port's
    step, got = ckpt.restore(jdir, lm_params_to_torch(tree, "cpu"))
    assert step == 7
    _close_tree(got, tree, 0, "port <- reference")
    assert got["opt"]["step"].dtype == torch.int32
    step, got = j_ckpt.restore(tdir, jax.tree.map(jnp.asarray, tree))
    assert step == 7
    _close_tree(jax.device_get(got), tree, 0, "reference <- port")


def test_checkpoint_latest_async_and_atomic(tmp_path):
    tree = {"a": torch.zeros(2), "b": {"c": torch.ones((128, 128))}}
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 1, tree)
    handle = ckpt.save(d, 5, tree, async_write=True)
    tree["b"]["c"].add_(1.0)         # the snapshot was taken before this
    handle.join()
    os.makedirs(tmp_path / "step_00000009.tmp")   # a crashed save
    assert ckpt.latest_step(d) == 5
    step, got = ckpt.restore(d, tree)
    assert step == 5 and torch.equal(got["b"]["c"], torch.ones(128, 128))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("micro,compress", [(1, False), (2, False),
                                            (1, True)])
def test_train_step_matches_the_reference(micro, compress):
    jcfg, tcfg = _reduced()
    jp = _j_params(jcfg, 1)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (4, 16)).astype(
        np.int32)
    lr = 1e-3
    jo, to = j_opt.make_optimizer("adamw", lr=lr), opt.make_optimizer(
        "adamw", lr=lr)
    jt = j_comp.make_compressor(0) if compress else None
    tt = comp.make_compressor(0) if compress else None
    jstep = jax.jit(j_make_train_step(jcfg, jo, microbatches=micro,
                                      grad_transform=jt))
    tstep = make_train_step(tcfg, to, microbatches=micro, grad_transform=tt)
    js = jo.init(jp)
    tp = lm_params_to_torch(jp, "cpu")
    ts = to.init(tp)
    jm, jp2, js2 = jstep(jp, js, {"tokens": jnp.asarray(toks)})
    tm, tp2, ts2 = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    _close_tree(tp2, jax.device_get(jp2), 2 * lr if compress else 0.05 * lr,
                "params")


def test_clip_and_microbatch_accumulation_are_the_reference_order():
    """Two microbatches equal the mean of the two halves' steps' grads."""
    _, tcfg = _reduced()
    params = build_model(tcfg).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, (4, 16)).astype(np.int32))
    loss = lambda p, b: step_mod.loss_fn(p, b, tcfg)   # noqa: E731
    l0, g0 = step_mod._value_and_grad(loss, params, {"tokens": toks[:2]})
    l1, g1 = step_mod._value_and_grad(loss, params, {"tokens": toks[2:]})
    seen = {}

    def grab(grads):
        seen["g"] = grads
        return grads
    st = make_train_step(tcfg, opt.make_optimizer("adamw"), microbatches=2,
                         max_grad_norm=1e9, grad_transform=grab)
    m, _, _ = st(params, opt.adamw_init(params), {"tokens": toks})
    assert torch.equal(m["loss"], (torch.zeros(()) + l0 + l1) * 0.5)
    want = tree_map(lambda a, b: (torch.zeros_like(a) + a + b) * 0.5, g0, g1)
    for a, b in zip(tree_flatten_with_path(seen["g"])[1],
                    tree_flatten_with_path(want)[1]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- trainer
def test_straggler_monitor_flags_what_the_reference_flags():
    rng = np.random.default_rng(9)
    a, b = StragglerMonitor(window=8), JMonitor(window=8)
    for i in range(200):
        host = int(rng.integers(0, 3))
        dur = float(rng.lognormal(0, 0.6)) * (8 if rng.random() < 0.05 else 1)
        assert a.observe(i, host, dur) == b.observe(i, host, dur)
    assert a.events == b.events and len(a.events) > 0


def test_trainer_losses_match_the_reference_from_its_step0_checkpoint(
        tmp_path):
    jcfg, tcfg = _reduced()
    jp = jax.tree.map(jnp.asarray, _j_params(jcfg, 3))
    j_ckpt.save(str(tmp_path / "j"), 0,
                {"params": jp, "opt": j_opt.adamw_init(jp)})
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(steps=4, global_batch=2, seq_len=16, ckpt_every=100,
              log_every=0, async_ckpt=False)
    jh = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                       **kw)).train()
    th = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                 device="cpu").train()
    assert [r["step"] for r in th] == [r["step"] for r in jh] == [0, 1, 2, 3]
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=TOL)
    assert th[-1]["loss"] < th[0]["loss"]
    # and both final checkpoints hold the same tree
    _, jf = j_ckpt.restore(str(tmp_path / "j"), {"params": jp,
                                                 "opt": j_opt.adamw_init(jp)})
    like = lm_params_to_torch(jax.device_get(
        {"params": jp, "opt": j_opt.adamw_init(jp)}), "cpu")
    _, tf = ckpt.restore(str(tmp_path / "t"), like)
    _close_tree(tf["params"], jax.device_get(jf["params"]), 1e-4, "final")


class _Kill(Exception):
    pass


def test_resume_after_a_kill_is_bitwise_on_the_cpu(tmp_path):
    """At one intra-op thread (set above): with several, MKL may pick its
    thread count by load and round a product otherwise."""
    _, tcfg = _reduced()
    kw = dict(steps=6, global_batch=2, seq_len=16, ckpt_every=3, log_every=0)
    full = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **kw),
                   device="cpu").train()

    def kill(trainer, row):
        if row["step"] == 4:
            raise _Kill()
    t = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **kw),
                hooks=[kill], device="cpu")
    with pytest.raises(_Kill):
        t.train()
    t._pending_ckpt.join()
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    again = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **kw),
                    device="cpu")
    assert again.start_step == 3
    rest = again.train()
    assert [r["step"] for r in rest] == [3, 4, 5]
    for a, b in zip(rest, full[3:]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_simulated_oom_fires_at_the_reference_budgets():
    jcfg, tcfg = _reduced()
    kw = dict(steps=1, global_batch=2, seq_len=16, log_every=0)
    t = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    j = JTrainer(jcfg, JTrainerConfig(**kw))
    assert t.footprint_gb() == j.footprint_gb()
    for budget, oom in ((t.footprint_gb() * 0.999, True),
                        (t.footprint_gb(), False)):
        for tr, cls in ((Trainer(tcfg, TrainerConfig(
                memory_budget_gb=budget, **kw), device="cpu"), SimulatedOOM),
                        (JTrainer(jcfg, JTrainerConfig(
                            memory_budget_gb=budget, **kw)), None)):
            if oom:
                with pytest.raises(RuntimeError, match="footprint"):
                    tr.train()
            else:
                tr.train()


def test_sizey_ladder_of_launch_train_is_the_reference(monkeypatch, capsys):
    """launch.train.main --sizey, three jobs sharing one sizer with a tiny
    preset: every OOM kill, retry allocation and final budget equal."""
    def run(launch, dev_kw):
        made = []
        real = launch.SizeyJobSizer

        def small(**kw):
            made.append(real(hbm_cap_gb=1024.0, preset_gb=0.001, **dev_kw))
            return made[-1]
        monkeypatch.setattr(launch, "SizeyJobSizer", small)
        lines = []
        for _ in range(3):
            argv = ["--arch", ARCH, "--scale", "reduced", "--steps", "1",
                    "--batch", "2", "--seq", "16", "--sizey"]
            if dev_kw:
                argv += ["--device", "cpu"]
            capsys.readouterr()
            trainer = launch.main(argv)
            out = capsys.readouterr().out.splitlines()
            lines += [ln for ln in out if ln.startswith(("Sizey", "OOM"))]
            # the next job shares this sizer
            monkeypatch.setattr(launch, "SizeyJobSizer",
                                lambda s=made[-1], **kw: s)
        return lines, trainer.footprint_gb()
    t_lines, t_fp = run(t_launch, {"device": "cpu"})
    j_lines, j_fp = run(j_launch, {})
    assert t_fp == j_fp
    assert t_lines == j_lines
    assert sum(ln.startswith("OOM") for ln in t_lines) >= 3


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_scaled_configs_are_the_reference_where_it_runs(arch):
    """launch.train's scales: the reference's configs, but at e2e-100m a
    KV-head count that divides the 10 query heads where the reference's
    does not (its own attention rejects those)."""
    for scale in ("reduced", "e2e-100m", "full"):
        t = t_launch.scaled_config(get_config(arch), scale)
        j = j_launch.scaled_config(j_get_config(arch), scale)
        if t.n_heads and j.n_heads % j.n_kv:
            assert scale == "e2e-100m" and t.n_heads % t.n_kv == 0
            assert t.n_kv == max(g for g in range(1, j.n_kv + 1)
                                 if 10 % g == 0)
            j = dataclasses.replace(j, n_kv=t.n_kv)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ------------------------------------------------- every architecture
def _arch_batch(cfg, b=2, s=32):
    rng = np.random.default_rng(0)
    if cfg.family == "vlm":
        return {"patch_embeds": rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, s - cfg.n_patches))
            .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_forward_and_grad_step_match_the_reference(arch):
    """tests/test_arch_smoke.py's forward and gradient step, the port
    beside ``jax.value_and_grad`` on the same parameters and batch."""
    assert tuple(J_ARCH_IDS) == tuple(ARCH_IDS)
    jcfg, tcfg = _reduced(arch)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _arch_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = lm_params_to_torch(jax.device_get(jp), "cpu")
    tl, taux = tm.forward(tp, tb)
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    assert tl.shape == (2, 32, tcfg.padded_vocab)
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL * float(np.abs(jl).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=0)
    jv, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tv, tg = step_mod._value_and_grad(tm.loss, tp, tb)
    assert float(tv) > 0
    np.testing.assert_allclose(float(tv), float(jv), rtol=TOL)
    _close_tree(tg, jax.device_get(jg), TOL, arch)
    gnorm = torch.sqrt(sum(torch.sum(g ** 2) for g in
                           tree_flatten_with_path(tg)[1]))
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b"])
def test_remat_changes_no_number(arch):
    _, tcfg = _reduced(arch)
    batch = {k: torch.from_numpy(v) for k, v in _arch_batch(tcfg).items()}
    params = build_model(tcfg).init(1, device="cpu")
    out = {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = step_mod._value_and_grad(build_model(cfg).loss, params,
                                              batch)
    for remat in ("block", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(tree_flatten_with_path(out[remat][1])[1],
                        tree_flatten_with_path(out["none"][1])[1]):
            assert torch.equal(a, b)
