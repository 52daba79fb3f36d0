"""One rank of a multi-process check of the port's distributed layer, for
``tests/test_torch_distributed.py``:

    python tests/torch_dist_worker.py CHECK RANK WORLD STORE_FILE OUT_DIR

Each rank joins a gloo group through a ``FileStore`` (no port), runs
CHECK on the CPU and exits 0, or raises. Imports torch and the port only.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


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
    lr = 3e-4
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
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        globals()[check](rank, world, out)
    finally:
        dist.destroy_process_group()
