"""One rank of a multi-process check of the port's distributed layer, for
``tests/test_torch_distributed.py``, ``test_torch_tp.py`` and
``test_torch_dryrun.py``:

    python tests/torch_dist_worker.py CHECK[:ARG] RANK WORLD STORE_FILE OUT_DIR

Each rank joins a gloo group through a ``FileStore`` (no port), runs
CHECK (with ARG, where it takes one) on the CPU and exits 0, or raises.
Imports torch and the port only. ``run_ranks`` starts the ranks for a
test.
"""
import collections
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(check, world, tmp_path, timeout=90):
    """Run ``check`` on ``world`` gloo ranks, one process each, joined
    through a ``FileStore`` in ``tmp_path`` (no port, so the xdist workers
    cannot collide); return each rank's output, or fail with the output
    of the first rank that did not exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), check, str(r),
         str(world), str(store), str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


def granite(rank, world, out):
    """The reduced granite-3-2b train step on a (2, 2) ("data", "model")
    mesh, weights placed by param_specs, the batch by batch_specs, against
    the single-device step from the same parameters: the loss, the
    gradient norm and every gradient within 1e-6 of the largest |value|
    (the data ranks' halves of the batch are summed in another order);
    the parameters after the AdamW step within 0.05 x lr, as
    tests/test_torch_train.py holds the port's step to the reference's
    (Adam's first update g / (|g| + eps) turns a 1e-7 difference of a
    gradient near eps into a visible one: ~1e-5 of the largest weight)."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs, shard)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    cfg = get_config("granite-3-2b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    lr = TP_LR
    opt = make_optimizer("adamw", lr=lr)
    _, g_ref = step_mod._value_and_grad(model.loss, params, batch)
    ref = tree_map(torch.clone, params)
    m_ref, ref, _ = make_train_step(cfg, opt)(ref, opt.init(ref), batch)
    mesh = make_test_mesh(2, 2, device_type="cpu")
    with axis_rules(mesh):
        dp = distribute(params, mesh, param_specs(params, mesh))
        state = opt.init(local_tree(dp))
        db = distribute(batch, mesh, batch_specs(batch, mesh))
        _, g_dp = step_mod._sharded(lambda p, b: step_mod._value_and_grad(
            model.loss, p, b), mesh)(dp, db)
        step = make_train_step(cfg, opt, mesh=mesh)
        m, dp, state = step(dp, state, db)
        # an annotation under rules lays a DTensor out by its logical axes
        x = distribute_tensor(torch.randn(4, 8, 2, 16), mesh,
                              (Replicate(), Replicate()))
        y = shard(x, ("batch", None, "heads", None))
        assert y.placements == (Shard(0), Shard(2)), y.placements
        assert torch.equal(y.full_tensor(), x.full_tensor())
        assert shard(y, ("batch", None, "heads", None)) is y
    wq = dp["blocks"]["attn"]["wq"]
    full = wq.shape
    assert tuple(wq.to_local().shape) == (full[0], full[1] // 2,
                                          full[2] // 2), wq.to_local().shape
    shards = [torch.zeros_like(wq.to_local()) for _ in range(world)]
    dist.all_gather(shards, wq.to_local().contiguous())
    assert len({s.numpy().tobytes() for s in shards}) == 4

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    worst = {k: rel(m[k], m_ref[k]) for k in ("loss", "grad_norm")}
    paths, got = tree_flatten_with_path(g_dp)
    for p, g, w in zip(paths, got, tree_flatten_with_path(g_ref)[1]):
        worst[f"grad {p}"] = rel(g.full_tensor(), w)
    bad = {k: v for k, v in worst.items() if v > 1e-6}
    assert not bad, bad
    moved, prel = 0.0, 0.0
    paths, got = tree_flatten_with_path(dp)
    for p, g, w in zip(paths, got, tree_flatten_with_path(ref)[1]):
        g = g.full_tensor()
        moved = max(moved, float((g - w).abs().max()) / lr)
        prel = max(prel, rel(g, w))
    assert moved <= 0.05, moved
    print(f"OK rank {rank}: loss {float(m['loss'])!r} vs "
          f"{float(m_ref['loss'])!r}; loss, grad norm and gradients "
          f"{max(worst.values()):.3e} apart at most; parameters "
          f"{moved:.3e} lr ({prel:.3e} of the largest)")


def _rel(a, b):
    """Largest |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ------------------------------------------------ tensor parallelism (TP)
TP_ARCHS = {"granite": "granite-3-2b", "phi": "phi3.5-moe-42b-a6.6b",
            "mamba2": "mamba2-780m", "zamba2": "zamba2-7b"}
TP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TP_BATCH, TP_SEQ, TP_LR = 4, 32, 3e-4
# The JAX reference's own spread at these inputs under 1-ulp moves of every
# weight (tools/port_tp_spread.py): the largest relative change of any
# gradient leaf, and the largest move after AdamW, in lr, of a parameter
# whose gradient lies near AdamW's eps (|g| <= NEAR_EPS). The TP step's
# gradients are held to 1e-6, or to twice the first where larger. Its
# parameters whose gradient exceeds NEAR_EPS are held to 0.05 lr: their
# first update g / (|g| + eps) is the gradient's sign within 1e-3, which
# the gradient limit fixes. The others are held to 0.05 lr, or to twice
# the second where larger (mamba2-780m: a 1-ulp move of the reference's
# weights moves one of them by 0.314 lr, the others 4.0e-4 lr at most).
NEAR_EPS = 1e3 * 1e-8
TP_SPREAD = {"granite": (8.809e-07, 0.03650), "phi": (1.182e-06, 0.02852),
             "mamba2": (1.319e-06, 0.3139), "zamba2": (1.273e-06, 0.04925)}


def tp_limits(arch):
    """(gradient limit, parameter limit near eps) of ``TP_ARCHS[arch]``."""
    return max(1e-6, 2 * TP_SPREAD[arch][0]), max(0.05, 2 * TP_SPREAD[arch][1])


def adamw_moves(got, want, grads, lr):
    """The largest |got - want| / lr over the parameters (matching lists of
    tensors) whose one-device gradient in ``grads`` exceeds NEAR_EPS, and
    over the others."""
    far = near = 0.0
    for g, w, gr in zip(got, want, grads):
        moved = (g - w).abs() / lr
        small = gr.abs() <= NEAR_EPS
        far = max(far, float(torch.where(small, 0.0, moved).max()))
        near = max(near, float(torch.where(small, moved, 0.0).max()))
    return far, near


def _replicated_flops(cfg, tokens, n_model, recompute):
    """FLOPs (fwd, its recompute, and 2x in the backward) of the products
    that every "model" rank computes in full or in part more than its
    1 / model share, per config, at ``tokens`` tokens a rank:

      * attention (dense, moe, hybrid): the whole KV heads a rank's query
        heads use, beyond its kvd / model columns of ``wk`` and ``wv``
        (the reduced configs' 2 KV heads over 4 ranks: 32 columns each
        against 16);
      * moe: the router, d x E, on every rank;
      * Mamba2 (ssm, hybrid): ``in_proj``'s B and C columns, d x 2N, and
        the scan's head-independent C B^T products, (Q x N) x (N x Q) a
        chunk, forward and the two of its backward."""
    from repro_torch.distributed import tp
    d, passes = cfg.d_model, 3 + recompute
    n = 0
    n_attn = cfg.n_attn_layers() if cfg.family != "ssm" else 0
    if n_attn:
        g = cfg.n_heads // cfg.n_kv
        worst = 0
        for r in range(n_model):
            h0, h1 = r * cfg.n_heads // n_model, \
                (r + 1) * cfg.n_heads // n_model
            worst = max(worst, ((h1 - 1) // g + 1 - h0 // g) * cfg.head_dim)
        extra = worst - cfg.n_kv * cfg.head_dim / n_model
        n += n_attn * passes * 2 * tokens * d * 2 * extra
    if cfg.family == "moe":
        n += cfg.n_layers * passes * 2 * tokens * d * cfg.n_experts
    if cfg.n_ssm_layers():
        q = min(128, TP_SEQ)
        per = passes * 2 * tokens * d * 2 * cfg.ssm_state \
            + passes * 2 * tokens * q * cfg.ssm_state
        n += cfg.n_ssm_layers() * per
    del tp
    return n


def tp_step(rank, world, out, arg):
    """The reduced ARCH train step on a MESH ("data", "model") gloo mesh
    (``ARG`` = "arch/mesh", of ``TP_ARCHS`` and ``TP_MESHES``, or
    "arch/mesh/seq": with ``cfg.seq_shard``, the residual stream a slice
    of the sequence on each "model" rank), tensor-
    parallel over "model" with each layer's weights gathered over "data",
    against the single-device step from the same parameters: the loss, the
    gradient norm and every gradient within 1e-6 of the largest |value|,
    the parameters after the AdamW step within 0.05 x lr (as ``granite``),
    those whose gradient lies near AdamW's eps within twice the
    reference's own spread where that is larger (``TP_SPREAD``);
    each rank's FLOPs (``FlopCounterMode`` over its loss and gradients) at
    most 1 / model of the single-device step's on its batch shard plus the
    replicated products (``_replicated_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    arch, mesh_name, *seq = arg.split("/")
    n_data, n_model = TP_MESHES[mesh_name]
    cfg = get_config(TP_ARCHS[arch]).reduced()
    if seq == ["seq"]:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                               (TP_BATCH, TP_SEQ))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    if cfg.family == "vlm":
        raise ValueError("no vlm config in TP_ARCHS")
    lr = TP_LR
    opt = make_optimizer("adamw", lr=lr)
    _, g_ref = step_mod._value_and_grad(model.loss, params, batch)
    ref = tree_map(torch.clone, params)
    m_ref, ref, _ = make_train_step(cfg, opt)(ref, opt.init(ref), batch)
    # the single-device FLOPs on this rank's batch shard, each block
    # recomputed as the sharded step recomputes it when it gathers
    recompute = n_data > 1
    one = dataclasses.replace(cfg, remat="block") if recompute else cfg
    shard = {"tokens": batch["tokens"][:TP_BATCH // n_data]}
    with FlopCounterMode(display=False) as fc:
        step_mod._value_and_grad(build_model(one).loss, params, shard)
    want_flops = fc.get_total_flops()
    mesh = make_test_mesh(n_data, n_model, device_type="cpu")
    with axis_rules(mesh):
        dp = distribute(params, mesh, param_specs(params, mesh))
        state = opt.init(local_tree(dp))
        db = distribute(batch, mesh, batch_specs(batch, mesh))
        with FlopCounterMode(display=False) as fc:
            _, g_dp = step_mod._sharded(
                lambda p, b: step_mod._value_and_grad(model.loss, p, b),
                mesh)(dp, db)
        got_flops = fc.get_total_flops()
        m, dp, state = make_train_step(cfg, opt, mesh=mesh)(dp, state, db)
    worst = {k: _rel(m[k], m_ref[k]) for k in ("loss", "grad_norm")}
    paths, got = tree_flatten_with_path(g_dp)
    for p, g, w in zip(paths, got, tree_flatten_with_path(g_ref)[1]):
        worst[f"grad {p}"] = _rel(g.full_tensor(), w)
    grad_tol, near_tol = tp_limits(arch)
    bad = {k: v for k, v in worst.items() if v > grad_tol}
    assert not bad, (bad, grad_tol)
    far, near = adamw_moves(
        [t.full_tensor() for t in tree_flatten_with_path(dp)[1]],
        tree_flatten_with_path(ref)[1], tree_flatten_with_path(g_ref)[1], lr)
    assert far <= 0.05 and near <= near_tol, (far, near, near_tol)
    extra = _replicated_flops(cfg, TP_BATCH // n_data * TP_SEQ, n_model,
                              recompute)
    limit = want_flops / n_model + extra
    assert got_flops <= limit, (got_flops, want_flops, extra)
    print(f"OK {cfg.name} rank {rank} on {n_data} x {n_model}: loss "
          f"{float(m['loss'])!r} vs {float(m_ref['loss'])!r}; loss, grad "
          f"norm and gradients {max(worst.values()):.3e} apart at most "
          f"(tol {grad_tol:.3e}); parameters {far:.3e} lr (tol 0.05), "
          f"those near eps {near:.3e} lr (tol {near_tol:.3e}); FLOPs "
          f"{got_flops} <= "
          f"{want_flops} / {n_model} + {extra:.0f} = {limit:.0f} "
          f"({got_flops / want_flops:.4f} of one device)")


def tp_one_rank(rank, world, out, arg=""):
    """Each of ``TP_ARCHS``' reduced train steps on a one-rank (1, 1) mesh
    bitwise the unsharded step: the loss, the gradient norm and every
    parameter after AdamW (a group of one gathers nothing and sums
    nothing); with ``ARG`` "seq", both with ``cfg.seq_shard``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    mesh = make_test_mesh(1, 1, device_type="cpu")
    for arch in TP_ARCHS.values():
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  seq_shard=arg == "seq")
        params = build_model(cfg).init(0, device="cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                                   (TP_BATCH, TP_SEQ))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        opt = make_optimizer("adamw", lr=3e-4)
        ref = tree_map(torch.clone, params)
        m_ref, ref, _ = make_train_step(cfg, opt)(ref, opt.init(ref), batch)
        with axis_rules(mesh):
            dp = distribute(params, mesh, param_specs(params, mesh))
            db = distribute(batch, mesh, batch_specs(batch, mesh))
            m, dp, _ = make_train_step(cfg, opt, mesh=mesh)(
                dp, opt.init(local_tree(dp)), db)
        got = tree_flatten_with_path(local_tree(dp))[1]
        want = tree_flatten_with_path(ref)[1]
        assert all(torch.equal(m[k], m_ref[k]) for k in ("loss",
                                                         "grad_norm")), arch
        assert all(torch.equal(a, b) for a, b in zip(got, want)), arch
        print(f"OK {arch}: loss, grad norm and {len(got)} parameters "
              f"bitwise on a one-rank mesh")


# ---------------------------------------------------- TP prefill and decode
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 32, 8
# The JAX reference's own spread at these inputs under 1-ulp moves of every
# weight (tools/port_tp_serve_spread.py): the largest relative change of
# any step's logits and of any cache leaf. The tensor-parallel steps are
# held to 1e-6 of the largest |value|, or to twice the spread where that is
# larger: the row-parallel products' partial sums and the slices' merge
# move the numbers by as much (1.01e-6 measured on zamba2-7b's logits).
SERVE_SPREAD = {"granite": (6.260e-07, 4.618e-07),
                "phi": (4.295e-07, 5.278e-07),
                "mamba2": (8.690e-07, 8.897e-07),
                "zamba2": (8.529e-07, 1.269e-06)}


def serve_limits(arch):
    """(logits limit, cache limit) of ``TP_ARCHS[arch]``'s serve."""
    return tuple(max(1e-6, 2 * v) for v in SERVE_SPREAD[arch])


# The port's unsharded steps against the JAX reference's on the same
# parameters and prompt, the reference fed its own greedy tokens (the same
# as the port's): the largest relative distance of any step's logits and of
# any leaf of the final cache (measured on the CPU). The tensor-parallel
# steps are held to the reference within twice these plus
# ``serve_limits`` (measured: 9.05e-7 on the logits, 7.43e-7 on a cache
# leaf at most).
SERVE_REF_GAP = {"granite": (5.074e-07, 4.288e-07),
                 "phi": (5.571e-07, 2.639e-07),
                 "mamba2": (9.358e-07, 7.700e-07),
                 "zamba2": (8.066e-07, 8.569e-07)}


def reference_limits(arch):
    """(logits limit, cache limit) of ``TP_ARCHS[arch]``'s serve against
    the JAX reference's steps."""
    return tuple(2 * g + t for g, t in zip(SERVE_REF_GAP[arch],
                                           serve_limits(arch)))


def load_reference(path):
    """The JAX reference's serve saved by the test (``reference_serve``):
    (each step's logits, the greedy tokens it fed, (None, the final
    cache)) as ``_serve_one_device`` gives them."""
    from repro_torch.convert import lm_params_to_torch
    tree = lm_params_to_torch(load_tree(path), "cpu")
    steps = [tree["logits"][str(i)] for i in range(SERVE_STEPS + 1)]
    fed = [tree["fed"][str(i)] for i in range(SERVE_STEPS)]
    return steps, fed, (None, tree["cache"])


def serve_faults(worst, limits):
    """The entries of ``serve_distance``'s ``worst`` beyond ``limits``."""
    return {k: v for k, v in worst.items()
            if v > limits[0 if k.startswith("logits") else 1]}


def load_tree(path):
    """A nested dict of numpy arrays saved by ``save_params`` (an ``.npz``
    of "/"-joined paths)."""
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return tree


def load_params(path):
    """A parameter tree saved by ``save_params``, as the port's CPU
    tensors."""
    from repro_torch.convert import lm_params_to_torch
    return lm_params_to_torch(load_tree(path), "cpu")


def save_params(tree, path):
    """Save a nested dict of numpy arrays for ``load_params``."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)


def _serve_one_device(cfg, params, prompt):
    """The unsharded prefill and SERVE_STEPS greedy decode steps: the
    logits of each step, the tokens fed and the final cache."""
    import copy

    from repro_torch.models.model import decode_step, prefill
    max_seq = SERVE_PROMPT + SERVE_STEPS
    logits, cache = prefill(params, {"tokens": prompt}, cfg, max_seq=max_seq)
    steps, fed = [logits], []
    caches = [copy.deepcopy(cache)]
    for _ in range(SERVE_STEPS):
        tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None].to(torch.int32)
        fed.append(tok)
        logits, cache = decode_step(params, cache, tok, cfg)
        steps.append(logits)
    caches.append(cache)
    return steps, fed, caches


def _serve_sharded(cfg, params, prompt, fed, mesh, mode):
    """The same through ``dryrun.serve_step`` on ``mesh``, weights placed
    by ``param_specs(mode=mode)``: each step's logits, the cache after
    prefill and at the end (each leaf as ``_shard``), the final cache's
    DTensors and their specs."""
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  param_specs)
    from repro_torch.launch import dryrun
    max_seq = SERVE_PROMPT + SERVE_STEPS
    with axis_rules(mesh):
        dp = distribute(params, mesh, param_specs(params, mesh, mode=mode))
        batch = {"tokens": prompt}
        specs = dryrun.serve_specs(cfg, "prefill", mesh, batch,
                                   max_seq=max_seq)
        logits, cache = dryrun.serve_step(
            cfg, "prefill", mesh, dp, distribute(batch, mesh,
                                                 specs["inputs"]),
            max_seq=max_seq)
        steps = [_shard(logits)]
        first = _shards(cache)
        for tok in fed:
            specs = dryrun.serve_specs(cfg, "decode", mesh,
                                       {"tokens": tok, "cache": cache})
            tokens = distribute({"tokens": tok}, mesh,
                                {"tokens": specs["inputs"]["tokens"]})
            logits, cache = dryrun.serve_step(
                cfg, "decode", mesh, dp, {"tokens": tokens["tokens"],
                                          "cache": cache})
            steps.append(_shard(logits))
    return steps, first, _shards(cache), cache, specs["cache"]


def _shard(t):
    """A DTensor as (a copy of this rank's shard, the slices of the whole
    tensor it holds): no collective (the card's gloo crashed in an
    all-gather of CUDA tensors)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return t.to_local().clone(), tuple(slice(o, o + n)
                                       for o, n in zip(off, shape))


def _shards(cache):
    from repro_torch.utils.misc import tree_flatten_with_path
    paths, leaves = tree_flatten_with_path(cache)
    return dict(zip(paths, (_shard(t) for t in leaves)))


def _leaves(cache):
    from repro_torch.utils.misc import tree_flatten_with_path
    paths, leaves = tree_flatten_with_path(cache)
    return {p: t.clone() for p, t in zip(paths, leaves)}


def _local_shapes_of(cache, specs, mesh):
    """Each cache leaf's local shard shape, and the shape ``specs`` give
    its global shape on this rank of ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import placements
    from repro_torch.utils.misc import tree_flatten_with_path
    paths, leaves = tree_flatten_with_path(cache)
    _, spec_leaves = tree_flatten_with_path(specs)
    got = {}
    for p, t, sp in zip(paths, leaves, spec_leaves):
        want, _ = compute_local_shape_and_global_offset(
            t.shape, mesh, placements(sp, mesh, t.dim()))
        got[p] = (tuple(t.to_local().shape), tuple(want))
    return got


def serve_distance(cfg, got, want):
    """(the largest distance of this rank's shard of each step's logits
    (over the true vocab, not its padding) and of each cache leaf in
    ``got`` (``_serve_sharded``'s) from the same part of ``want``
    (``_serve_one_device``'s, or ``load_reference``'s, which has no
    prefill cache), relative to the largest |value| of ``want``'s whole
    tensor, by name; whether the greedy tokens of every step agree)."""
    steps, first, last = got[:3]
    w_steps, _, (w_first, w_last) = want
    worst, greedy = {}, True
    def rel(g, w, sl):
        """|g - w[sl]| over the largest |w| (the whole tensor's)."""
        g, w = g.float(), w.float()
        return float((g - w[sl]).abs().max()
                     / w.abs().max().clamp_min(1e-30))
    for i, ((g, sl), w) in enumerate(zip(steps, w_steps)):
        g, w = g[..., :cfg.vocab], w[..., :cfg.vocab]
        worst[f"logits {i}"] = rel(g, w, sl)
        greedy &= torch.equal(g[:, -1].argmax(-1), w[sl][:, -1].argmax(-1))
    for tag, g_tree, w_tree in (("prefill", first, w_first),
                                ("end", last, w_last)):
        if w_tree is None:
            continue
        w_tree = _leaves(w_tree)
        assert set(g_tree) == set(w_tree)
        for p, (g, sl) in g_tree.items():
            w = w_tree[p]
            assert g.shape == w[sl].shape and g.dtype == w.dtype, p
            worst[f"{tag} {p}"] = rel(g, w, sl) if w.is_floating_point() \
                else float(not torch.equal(g, w[sl]))
    return worst, greedy


def tp_serve(rank, world, out, arg):
    """The reduced ARCH's prefill and SERVE_STEPS greedy decode steps on a
    MESH ("data", "model") gloo mesh (``ARG`` = "arch/mesh", or
    "arch/mesh/seq": the prefill with ``cfg.seq_shard``), tensor-
    parallel over "model" with the cache laid out by ``cache_specs``,
    weights by ``param_specs`` in both its modes (ZeRO-3: each layer
    gathered over "data"; "inference": "model" only), from the reference's
    parameters (``params_<arch>.npz`` in ``out``, written by the test),
    against the unsharded steps: every step's logits and every cache leaf
    (after prefill and at the end), shard by shard, within
    ``serve_limits`` of the largest |value| of one device's, the greedy
    tokens equal, and each cache shard the shape ``cache_specs`` gives
    it; and against the JAX reference's steps (``ref_<arch>.npz``): the
    same greedy tokens, every step's logits and the final cache's shards
    within ``reference_limits``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    arch, mesh_name, *seq = arg.split("/")
    n_data, n_model = TP_MESHES[mesh_name]
    cfg = get_config(TP_ARCHS[arch]).reduced()
    if seq == ["seq"]:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    params = load_params(f"{out}/params_{arch}.npz")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32))
    want = _serve_one_device(cfg, params, prompt)
    ref = load_reference(f"{out}/ref_{arch}.npz")
    assert all(torch.equal(a, b) for a, b in zip(want[1], ref[1])), \
        "the unsharded greedy tokens are not the reference's"
    mesh = make_test_mesh(n_data, n_model, device_type="cpu")
    for mode in ("train", "inference"):
        got = _serve_sharded(cfg, params, prompt, want[1], mesh, mode)
        worst, greedy = serve_distance(cfg, got, want)
        assert greedy, (mode, "greedy tokens differ")
        shapes = _local_shapes_of(got[3], got[4], mesh)
        bad_shape = {p: s for p, s in shapes.items() if s[0] != s[1]}
        assert not bad_shape, bad_shape
        limits = serve_limits(arch)
        bad = serve_faults(worst, limits)
        assert not bad, (mode, bad, limits)
        ref_worst, ref_greedy = serve_distance(cfg, got, ref)
        assert ref_greedy, (mode, "greedy tokens differ from the reference")
        ref_limits = reference_limits(arch)
        bad = serve_faults(ref_worst, ref_limits)
        assert not bad, (mode, "against the reference", bad, ref_limits)
        print(f"OK {cfg.name} rank {rank} on {n_data} x {n_model}, weights "
              f"{mode}: prefill and {SERVE_STEPS} decode steps' logits and "
              f"{len(got[2])} cache leaves {max(worst.values()):.3e} apart "
              f"at most (tol {limits[0]:.3e} and {limits[1]:.3e}); greedy "
              f"tokens equal; cache shards "
              f"{sorted(set(s[0] for s in shapes.values()))} as "
              f"cache_specs lays them out; against the JAX reference "
              f"logits {max(v for k, v in ref_worst.items() if k.startswith('logits')):.3e} "
              f"and final cache "
              f"{max(v for k, v in ref_worst.items() if not k.startswith('logits')):.3e} "
              f"(tol {ref_limits[0]:.3e} and {ref_limits[1]:.3e})")


def tp_serve_one_rank(rank, world, out, arg=""):
    """Each of ``TP_ARCHS``' reduced prefill and SERVE_STEPS decode steps
    through ``dryrun.serve_step`` on a one-rank (1, 1) mesh bitwise the
    unsharded steps: every step's logits and the caches; with ``ARG``
    "seq", both with ``cfg.seq_shard``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, 1, device_type="cpu")
    for arch in TP_ARCHS:
        cfg = dataclasses.replace(get_config(TP_ARCHS[arch]).reduced(),
                                  seq_shard=arg == "seq")
        params = load_params(f"{out}/params_{arch}.npz")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32))
        want = _serve_one_device(cfg, params, prompt)
        steps, first, last = _serve_sharded(cfg, params, prompt, want[1],
                                            mesh, "train")[:3]
        pairs = [(g, w[sl]) for (g, sl), w in zip(steps, want[0])]
        for g_tree, w_tree in ((first, want[2][0]), (last, want[2][1])):
            w_tree = _leaves(w_tree)
            pairs += [(g, w_tree[p][sl]) for p, (g, sl) in g_tree.items()]
        assert all(torch.equal(a, b) for a, b in pairs), arch
        print(f"OK {arch}: prefill and {SERVE_STEPS} decode steps bitwise "
              f"over {len(pairs)} tensors on a one-rank mesh")


def _run(fn, args, mesh=None):
    """(``fn(*args)``, the gradients of its floating inputs) of a fixed
    weighting of its output (the same on every rank), under TP over
    ``mesh`` when given."""
    from repro_torch.distributed import tp
    args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    if mesh is None:
        y = fn(*args)
    else:
        with tp.sharded(mesh):
            y = fn(*args)
    w = torch.linspace(-1.0, 1.0, y.numel(), dtype=y.dtype).reshape(y.shape)
    torch.autograd.backward((y * w).sum())
    return y.detach(), [a.grad for a in args if a.requires_grad]


def _tp_pair(fn, full, shards):
    """``fn`` on the whole tensors ``full`` on one device, and on this
    rank's ``shards`` under TP over a (1, world) mesh: (one-device output,
    TP output, one-device gradients, TP gradients), each gradient of the
    same input in the same order."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, dist.get_world_size(), device_type="cpu")
    y1, g1 = _run(fn, full)
    y2, g2 = _run(fn, shards, mesh)
    return y1, y2, g1, g2


def tp_unit(rank, world, out, arg):
    """One piece of ``distributed.tp`` on ``world`` "model" ranks against
    one device, at a small size (forward and every gradient within 1e-6 of
    the largest |value|; the embedding bitwise):

      * vocab: the vocab-parallel embedding, logits and cross-entropy on a
        true vocab of 300 in a padded 512 (the padded tail straddles a
        rank's columns);
      * mlp: the column- then row-parallel SwiGLU;
      * gqa: attention with 2 KV heads over 4 ranks (with biases);
      * uneven: 10 query heads on 10 KV heads over 4 ranks (2 or 3 whole
        heads a rank, as qwen1.5-32b's 40 over 16; a head's columns split
        across two ranks' shards);
      * seq: the sequence-parallel pair (``seq=True``) around the SwiGLU,
        the rank's slice of a 12-position sequence in and out, and the
        embedding reduce-scattered onto the slice after a prefix of 4
        positions (the VLM's patches; bitwise), each gradient from a fixed
        weighting of the rank's slice of the output.

    The attention checks hold each tensor to the larger of 1e-6 and twice
    the one-device step's own spread: the same block with its heads in
    reverse order (a bias gradient sums each head's outputs over every
    position, and the heads' order alone moves it by ~1e-6)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import tp
    from repro_torch.models import attention, layers
    m, r = world, rank
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, std=0.5):
        return torch.randn(shape, generator=gen) * std

    def cols(t, dim=-1):
        return torch.chunk(t, m, dim)[r]
    checks = []
    spread = collections.defaultdict(float)
    if arg == "vocab":
        cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                                  vocab=300, d_model=16)
        v = cfg.padded_vocab
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 12)))
        table, head = rnd(v, 16), rnd(16, v)
        labels = torch.roll(tokens, -1, 1)
        mask = torch.ones(2, 12)
        mask[:, -1] = 0.0

        def loss(t, hd):
            h = layers.embed_tokens({"embed": t}, tokens, torch.float32)
            logits = layers.logits_fn({"lm_head": hd}, torch.tanh(h), cfg)
            return layers.cross_entropy(logits, labels, mask)[None]
        y1, y2, g1, g2 = _tp_pair(loss, [table, head],
                                  [cols(table, 0), cols(head)])
        checks += [("loss", y2, y1), ("d embed", g2[0], cols(g1[0], 0)),
                   ("d lm_head", g2[1], cols(g1[1]))]

        def emb(t):
            return layers.embed_tokens({"embed": t}, tokens, torch.float32)
        e1, e2, ge1, ge2 = _tp_pair(emb, [table], [cols(table, 0)])
        assert torch.equal(e1, e2), "the embedding is not bitwise"
        checks += [("d embed (lookup)", ge2[0], cols(ge1[0], 0))]
    elif arg == "mlp":
        x, wg, wu, wd = rnd(2, 8, 16), rnd(16, 64), rnd(16, 64), rnd(64, 16)

        def mlp(x, wg, wu, wd):
            return layers.mlp({"w_gate": wg, "w_up": wu, "w_down": wd}, x,
                              torch.float32)
        y1, y2, g1, g2 = _tp_pair(mlp, [x, wg, wu, wd],
                                  [x, cols(wg), cols(wu), cols(wd, 0)])
        checks += [("out", y2, y1), ("dx", g2[0], g1[0]),
                   ("d w_gate", g2[1], cols(g1[1])),
                   ("d w_up", g2[2], cols(g1[2])),
                   ("d w_down", g2[3], cols(g1[3], 0))]
    elif arg == "seq":
        import contextlib

        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(1, m, device_type="cpu")
        x, wg, wu, wd = rnd(2, 12, 16), rnd(16, 64), rnd(16, 64), rnd(64, 16)
        table, prefix = rnd(64, 16), rnd(2, 4, 16)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, 64, (2, 8)))
        wt, we = rnd(2, 12, 16), rnd(2, 12, 16)

        def run(seq):
            if seq:
                args = [cols(x, 1), cols(wg), cols(wu), cols(wd, 0),
                        cols(table, 0)]
            else:
                args = [x, wg, wu, wd, table]
            args = [a.detach().requires_grad_() for a in args]
            with tp.sharded(mesh) if seq else contextlib.nullcontext():
                y = layers.mlp({"w_gate": args[1], "w_up": args[2],
                                "w_down": args[3]}, args[0], torch.float32,
                               seq)
                e = layers.embed_tokens({"embed": args[4]}, tokens,
                                        torch.float32, prefix, seq)
            pick = (lambda t: cols(t, 1)) if seq else (lambda t: t)
            ((y * pick(wt)).sum() + (e * pick(we)).sum()).backward()
            return y.detach(), e.detach(), [a.grad for a in args]
        y1, e1, g1 = run(False)
        y2, e2, g2 = run(True)
        assert torch.equal(e2, cols(e1, 1)), "the embedding is not bitwise"
        checks += [("out", y2, cols(y1, 1)), ("dx", g2[0], cols(g1[0], 1)),
                   ("d w_gate", g2[1], cols(g1[1])),
                   ("d w_up", g2[2], cols(g1[2])),
                   ("d w_down", g2[3], cols(g1[3], 0)),
                   ("d embed", g2[4], cols(g1[4], 0))]
    elif arg in ("gqa", "uneven"):
        base = get_config("granite-3-2b").reduced()
        shapes = [(4, 2)] if arg == "gqa" else [(10, 10)]
        for n_heads, n_kv in shapes:
            cfg = dataclasses.replace(base, d_model=16, n_heads=n_heads,
                                      n_kv=n_kv, head_dim=8, qkv_bias=True)
            qd, kvd = n_heads * 8, n_kv * 8
            names = ["wq", "wk", "wv", "wo", "bq", "bk", "bv"]
            full = [rnd(16, qd), rnd(16, kvd), rnd(16, kvd), rnd(qd, 16),
                    rnd(qd), rnd(kvd), rnd(kvd)]
            x = rnd(2, 12, 16, std=1.0)
            pos = torch.arange(12)[None].expand(2, 12)

            def block(x, *ws):
                return attention.attention_block(dict(zip(names, ws)), x,
                                                 cfg, pos)[0]
            q_rev = torch.arange(qd).reshape(n_heads, 8).flip(0).flatten()
            kv_rev = torch.arange(kvd).reshape(n_kv, 8).flip(0).flatten()
            rev = [q_rev, kv_rev, kv_rev, q_rev, q_rev, kv_rev, kv_rev]

            def reversed_heads(x, *ws):
                ws = [w.index_select(-1 if nm != "wo" else 0, i)
                      for nm, w, i in zip(names, ws, rev)]
                return attention.attention_block(dict(zip(names, ws)), x,
                                                 cfg, pos)[0]
            local = [cols(full[0]), cols(full[1]), cols(full[2]),
                     cols(full[3], 0), *full[4:]]
            y1, y2, g1, g2 = _tp_pair(block, [x, *full], [x, *local])
            y3, g3 = _run(reversed_heads, [x, *full])
            tag = f"{n_heads}/{n_kv}"
            checks += [(f"{tag} out", y2, y1), (f"{tag} dx", g2[0], g1[0])]
            spread[f"{tag} out"] = _rel(y3, y1)
            spread[f"{tag} dx"] = _rel(g3[0], g1[0])
            for i, nm in enumerate(names):
                want = g1[i + 1]
                spread[f"{tag} d {nm}"] = _rel(g3[i + 1], want)
                if nm in ("wq", "wk", "wv"):
                    want = cols(want)
                elif nm == "wo":
                    want = cols(want, 0)
                checks.append((f"{tag} d {nm}", g2[i + 1], want))
            if arg == "uneven":
                sizes = {h1 - h0 for (h0, h1), _ in
                         tp.head_split(n_heads, n_kv, m)}
                assert sizes == {2, 3}, sizes
    else:
        raise ValueError(arg)
    worst = {k: _rel(a, b) for k, a, b in checks}
    bad = {k: v for k, v in worst.items() if v > max(1e-6, 2 * spread[k])}
    assert not bad, (bad, spread)
    print(f"OK {arg} rank {rank}: {len(checks)} tensors, "
          f"{max(worst.values()):.3e} apart at most; the one-device "
          f"spread {max(spread.values(), default=0.0):.3e} at most")


def tp_seq_peak(rank, world, out):
    """The reduced granite-3-2b, phi3.5-moe and mamba2-780m train steps on
    a (1, 4) ("data", "model") gloo mesh, with and without
    ``cfg.seq_shard``: ``dryrun.LiveMode``'s peak of live bytes over each
    step, which must be lower with the residual stream a slice of the
    sequence. Written to ``out``/seq_peak_<rank>.json."""
    import json

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    mesh = make_test_mesh(1, 4, device_type="cpu")
    got = {}
    for arch in ("granite", "phi", "mamba2"):
        for seq in (False, True):
            cfg = dataclasses.replace(get_config(TP_ARCHS[arch]).reduced(),
                                      seq_shard=seq)
            tokens = np.random.default_rng(0).integers(0, cfg.vocab,
                                                       (TP_BATCH, TP_SEQ))
            with axis_rules(mesh):
                params = init_params(cfg, 0, device="cpu")
                params = distribute(params, mesh, param_specs(params, mesh))
                opt = make_optimizer("adamw")
                state = opt.init(local_tree(params))
                batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
                batch = distribute(batch, mesh, batch_specs(batch, mesh))
                args = (params, state, batch)
                with dryrun.LiveMode(args) as live:
                    make_train_step(cfg, opt, mesh=mesh)(*args)
            got[f"{arch}/{'seq' if seq else 'tp'}"] = live.peak
    with open(f"{out}/seq_peak_{rank}.json", "w") as f:
        json.dump(got, f)
    low = {a: got[f"{a}/seq"] < got[f"{a}/tp"] for a in ("granite", "phi",
                                                         "mamba2")}
    assert all(low.values()), got
    print(f"OK rank {rank}: peaks {got}")


def dry_real(rank, world, out, arg=""):
    """The dry run's (2, 2) cells of ``tests/test_torch_dryrun.py`` (the
    reduced granite-3-2b, 4 x 64 tokens; with ``ARG`` "seq",
    ``cfg.seq_shard``) run for real: each rank writes
    its ``FlopCounterMode`` count and ``dryrun.LiveMode``'s peak of live
    bytes over the AdamW train step, and its counts over the prefill and
    a decode step on a 64-position cache (to ``out``/dry_<rank>.json), for
    the test to hold the traced cells to."""
    import json

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, batch_specs,
                                                  distribute, local_tree,
                                                  param_specs)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              seq_shard=arg == "seq")
    mesh = make_test_mesh(2, 2, device_type="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 64))
    with axis_rules(mesh):
        params = init_params(cfg, 0, device="cpu")
        params = distribute(params, mesh, param_specs(params, mesh))
        opt = make_optimizer("adamw")
        state = opt.init(local_tree(params))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        batch = distribute(batch, mesh, batch_specs(batch, mesh))
        step = make_train_step(cfg, opt, mesh=mesh)
        args = (params, state, batch)
        with dryrun.LiveMode(args) as live, \
                FlopCounterMode(display=False) as fc:
            held = live.live
            step(*args)
    got = {"flops": fc.get_total_flops(), "peak_gb": live.peak / 1024**3,
           "argument_gb": held / 1024**3}
    from repro_torch.models.model import init_cache
    params = init_params(cfg, 0, device="cpu")
    with axis_rules(mesh):
        dp = distribute(params, mesh, param_specs(params, mesh))
        prompt = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        decode = {"tokens": prompt["tokens"][:, :1],
                  "cache": init_cache(cfg, 4, 64, "cpu")}
        for kind, inputs in (("prefill", prompt), ("decode", decode)):
            specs = dryrun.serve_specs(cfg, kind, mesh, inputs)
            inputs = distribute(inputs, mesh, specs["inputs"])
            with FlopCounterMode(display=False) as fc:
                dryrun.serve_step(cfg, kind, mesh, dp, inputs)
            got[f"flops_{kind}"] = fc.get_total_flops()
    with open(f"{out}/dry_{rank}.json", "w") as f:
        json.dump(got, f)
    print(f"OK rank {rank}: {got}")


def elastic(rank, world, out):
    """The reference test's 8 -> 4 -> 8 (tests/test_distributed.py:56)."""
    from repro_torch.launch.elastic import ElasticController
    state = {"w_in": torch.ones((64, 64)), "bias": torch.zeros((8,))}
    ctl = ElasticController(state, device_type="cpu")
    n0 = ctl.mesh.size()
    assert ctl.maybe_rescale(range(4))          # lose half the fleet
    assert ctl.mesh.size() == 4
    assert not ctl.maybe_rescale(range(4))      # no change -> no-op
    assert ctl.maybe_rescale()                  # the fleet recovers
    assert ctl.mesh.size() == n0
    assert ctl.events == [(n0, 4), (4, n0)], ctl.events
    assert torch.equal(ctl.state["w_in"].full_tensor(),
                       torch.ones((64, 64)))
    print(f"OK rank {rank}: events {ctl.events}")


def psum(rank, world, out):
    """compressed_psum over an 8-rank "data" axis, one row each."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import prng
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.train.compression import compressed_psum
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = torch.from_numpy(np.linspace(-1, 1, world * 32, dtype=np.float32)
                         .reshape(world, 32))
    with axis_rules(mesh):
        got = compressed_psum({"g": g[rank:rank + 1]}, "data",
                              prng.prng_key(0))["g"]
    np.save(f"{out}/psum_{rank}.npy", got.numpy())
    print(f"OK rank {rank}")


def gpipe(rank, world, out):
    """The reference test's GPipe shapes (tests/test_distributed.py:104)
    on a 4-rank "stage" axis against the layers run in sequence."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import (make_stage_fn,
                                                  pipeline_apply,
                                                  split_stages)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    n_layers, d, mb, m = 8, 16, 4, 8
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(0, 0.3, (n_layers, d, d))
                          .astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (m, mb, d)).astype(np.float32))

    def layer_fn(w, h):
        return torch.tanh(h @ w)
    got = pipeline_apply(make_stage_fn(layer_fn), split_stages(ws, world),
                         x, mesh=mesh)
    want = x
    for i in range(n_layers):
        want = layer_fn(ws[i], want)
    err = float((got - want).abs().max())
    assert err < 1e-5, err
    print(f"OK rank {rank}: largest difference {err!r}")


def collectives(rank, world, out):
    """analysis.collectives' CollectiveCounter on a (2, 2) ("data",
    "model") mesh: each rank writes what it counted over one collective
    of each kind, a DTensor redistribution and a point-to-point exchange
    (to ``out``/collectives_<rank>.json) for the test to hold against its
    own count."""
    import json

    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.analysis.collectives import CollectiveCounter
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, device_type="cpu")
    data = mesh["data"]
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4) + rank
    with CollectiveCounter() as c:
        g = funcol.all_gather_tensor(x, 0, data)                 # (12, 4)
        r = funcol.all_reduce(x.double(), "sum", dist.group.WORLD)
        s = funcol.reduce_scatter_tensor(x, "sum", 0, data)      # (3, 4)
        a = funcol.all_to_all_single(x[:4].contiguous(), None, None, data)
        d = DTensor.from_local(x, mesh, (Shard(0), Replicate()),
                               run_check=False)
        full = d.redistribute(mesh, (Replicate(), Replicate()))  # (12, 4)
        peer = rank ^ 1
        if rank % 2 == 0:
            funcol.wait_tensor(torch.ops._c10d_functional.isend(
                x[:2].contiguous(), peer, 0, dist.group.WORLD.group_name))
            recv = torch.ops._c10d_functional.irecv(
                torch.empty(5, 4, dtype=torch.int16), peer, 0,
                dist.group.WORLD.group_name)
        else:
            recv = torch.ops._c10d_functional.irecv(
                torch.empty(2, 4), peer, 0, dist.group.WORLD.group_name)
            funcol.wait_tensor(torch.ops._c10d_functional.isend(
                torch.zeros(5, 4, dtype=torch.int16), peer, 0,
                dist.group.WORLD.group_name))
        funcol.wait_tensor(recv)
        for t in (g, r, s, a, full.to_local()):
            t.sum().item()
    with open(f"{out}/collectives_{rank}.json", "w") as f:
        json.dump(c.result(), f)
    print(f"OK rank {rank}: {c.result()}")


def serve_one_rank(rank, world, out):
    """launch.dryrun's sharded prefill and decode step on a one-rank
    (1, 1) mesh, bitwise the unsharded steps, from the same reduced
    zamba2-7b (attention, Mamba2 and the cache) and granite-3-2b."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (axis_rules, distribute,
                                                  param_specs)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.utils.misc import tree_flatten_with_path, tree_map
    mesh = make_test_mesh(1, 1, device_type="cpu")

    def full(tree):
        _, leaves = tree_flatten_with_path(tree)
        return [t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in leaves]
    for arch in ("zamba2-7b", "granite-3-2b"):
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(0, device="cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 24))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        step = torch.from_numpy(tokens[:, :1].astype(np.int32))
        logits, cache = prefill(params, batch, cfg)
        want = [logits, *full(cache)]
        # decode from a cache with room for the new position
        _, cache = prefill(params, batch, cfg, max_seq=32)
        inputs = {"tokens": step, "cache": tree_map(torch.clone, cache)}
        logits2, cache = decode_step(params, cache, step, cfg)
        want += [logits2, *full(cache)]
        with axis_rules(mesh):
            dp = distribute(params, mesh, param_specs(params, mesh))
            specs = dryrun.serve_specs(cfg, "prefill", mesh, batch)
            got_l, got_c = dryrun.serve_step(
                cfg, "prefill", mesh, dp,
                distribute(batch, mesh, specs["inputs"]))
            got = [got_l.full_tensor(), *full(got_c)]
            specs = dryrun.serve_specs(cfg, "decode", mesh, inputs)
            got_l, got_c = dryrun.serve_step(
                cfg, "decode", mesh, dp,
                distribute(inputs, mesh, specs["inputs"]))
            got += [got_l.full_tensor(), *full(got_c)]
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert a.shape == b.shape and torch.equal(a, b), arch
        print(f"OK {arch}: prefill and decode bitwise over {len(want)} "
              f"tensors")


if __name__ == "__main__":
    check, rank, world, store, out = sys.argv[1:6]
    check, _, arg = check.partition(":")
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        globals()[check](rank, world, out, *([arg] if arg else []))
    finally:
        dist.destroy_process_group()
