"""Multi-pod dry run on fake tensors over fake process groups.

The reference's ``repro/launch/dryrun.py`` on torch. Every (architecture x
input shape) cell of the port's train, prefill and decode steps is traced
against the production meshes, 16x16 = 256 ranks ("data", "model") and
2x16x16 = 512 ranks ("pod", "data", "model"), or (2, 2) and (2, 2, 2) with
``--test-mesh``. The ranks are a fake process group
(``torch.testing._internal.distributed.fake_pg``): this process plays
rank 0 of the world and every collective is a shape computation. Every
tensor is a fake tensor (``FakeTensorMode``): parameters, optimizer state,
batches and caches carry shapes and types, and nothing is allocated or
launched. With ``--device cuda`` (the default, on the card's machine) K4,
K5 and K6 run their registered fake kernels and FLOP formulas; with
``--device cpu`` (the tests) the plain versions run, as the reference's
probes force naive attention.

The train cells trace the port's sharded train step (``train.step``)
as it runs on a real mesh: weights and optimizer state placed by
``param_specs``, the loss and gradients through ``local_map`` on each
weight's own shard and this rank's batch shard, each layer's weights
gathered over the FSDP axes only while it runs (and again for its
backward), the blocks tensor-parallel over "model" (``distributed.tp``).
Prefill and decode (``serve_step``) run the same way: the weights as
they are placed (ZeRO-3 by ``param_specs``, or its ``"inference"`` mode,
"model" only, under ``--infer-tp`` by the reference's 8 GB rule), the
blocks tensor-parallel over "model", the batch over the FSDP axes where B
divides (not at ``long_500k``'s B = 1), and the cache as the reference's
``cache_specs`` lays it out: K/V sequence, SSM state heads and the
convolution tail's channels over "model". Decode runs K5's log-sum-exp
variant on each rank's slice of the cache and merges the slices across
"model". With ``--seq-shard`` the train and prefill cells carry the
residual stream between the blocks as each "model" rank's slice of the
sequence (``cfg.seq_shard``: gathered into each block, reduce-scattered
out of it, each an all-to-all).

Per card, each row records:

  * FLOPs: ``torch.utils.flop_counter`` over the step. The step's compute
    runs on local tensors inside ``local_map``, so the count is this
    rank's own (a count over DTensor ops would be global);
  * bytes: each dispatched op's tensor inputs read and outputs written
    once, as an eager step moves them (no fusion; views, allocations and
    collectives move none; ``moved_bytes``);
  * collective bytes (``analysis.collectives``) of the whole step;
  * memory from the live fake storages of this rank's tensors
    (``TraceMode``; ``LiveMode`` keeps the same books over a real run):
    ``argument_gb`` the parameters, optimizer state,
    batch and cache at entry; ``peak_gb`` the most held at once during
    the step (kernel scratch included: the fake kernels allocate it);
    ``temp_gb`` the peak less the arguments; ``alias_gb`` what the step
    updates in place (parameters and optimizer state, the decode cache);
    ``output_gb`` what it returns newly allocated.

No depth probes: the reference compiles depth 0 and one layer unit
because XLA's cost analysis counts a loop body once. The port's layers
are a Python loop, so one trace at full depth counts every op, and the
row's collectives are those of the whole step.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun \
          --out results/dryrun_torch.jsonl
Table: REPRO_DRYRUN_RESULTS=results/dryrun_torch.jsonl \
          python -m benchmarks.roofline
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.collectives import CollectiveCounter
from repro_torch.analysis.roofline import roofline_terms
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_applicable,
                                 get_config)
from repro_torch.distributed.sharding import (FSDP_AXES, MODEL_AXIS, P,
                                              axis_names, axis_rules,
                                              cache_specs, param_specs,
                                              placements)
from repro_torch.launch.inputs import cache_spec, input_specs
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.model import decode_step, init_params, prefill
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.utils.misc import tree_bytes, tree_map

GIB = 1024 ** 3
# ops that move no bytes: allocations (their contents are not written),
# views and metadata queries
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "detach", "alias", "lift_fresh",
                       "_local_scalar_dense", "_unsafe_view"})
_NO_BYTES_NAMESPACES = frozenset({"prim", "_c10d_functional",
                                  "c10d_functional", "c10d"})


# --------------------------------------------------------------- tracing
class _Books:
    """The bytes of the live storages of the tensors that the ops a mode
    sees return (each storage counted once, released when it dies) and
    their peak."""

    def _open_books(self, live: int = 0) -> None:
        self.live = live
        self.peak = live
        self._held: set[int] = set()

    def reset(self) -> None:
        """Start a new peak (and a new count of moved bytes)."""
        self.peak = self.live
        self.moved = 0

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def release(n=n, key=key):
            self.live -= n
            self._held.discard(key)
        weakref.finalize(st, release)


class TraceMode(_Books, FakeTensorMode):
    """A ``FakeTensorMode`` that keeps the books of the tensors it makes:
    the bytes of live storages (each counted once, released when the
    storage dies), their peak, and the bytes each op reads and writes.
    A fake kernel runs inside the mode, so its scratch is counted too;
    the bytes moved are counted for the ops the step dispatches, not for
    the ops the mode runs inside them (a decomposition, a fake kernel's
    allocations)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._open_books()
        self.moved = 0
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented:
            return out
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        if self._depth == 0 and not func.is_view \
                and func.namespace not in _NO_BYTES_NAMESPACES \
                and func._opname not in _NO_BYTES:
            self.moved += moved_bytes(func, args, kwargs or {}, outs)
        return out


class LiveMode(_Books, TorchDispatchMode):
    """``TraceMode``'s books of live storages over a real run: ``live``
    starts with the storages of the local tensors in ``tree`` (the step's
    arguments), and each storage an op returns is added until it dies.
    DTensors pass on to their local ops.

    A collective runs on copies of its inputs and is waited for here, and
    the step gets a copy of its result: a process group's worker thread
    holds the tensors of the work it ran until some time after the wait
    returns, so a storage the step handed to it or got from it would die
    there, late, by a time the scheduler sets. The books see only the
    step's own tensors, which die where the step drops them, as the fake
    process group's do in ``TraceMode``."""

    def __init__(self, tree=()):
        super().__init__()
        self._open_books()
        for t in pytree.tree_leaves(tree):
            t = getattr(t, "_local_tensor", t)
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from repro_torch.analysis.collectives import kind_of
        if DTensor in types:
            return NotImplemented
        if kind_of(func) is not None and not func._schema.is_mutable:
            def mine(t):
                return t.clone() if isinstance(t, torch.Tensor) else t
            done = pytree.tree_map(
                lambda t: torch.ops._c10d_functional.wait_tensor(t)
                if isinstance(t, torch.Tensor) else t,
                func(*pytree.tree_map(mine, args),
                     **pytree.tree_map(mine, kwargs or {})))
            out = pytree.tree_map(mine, done)
            del done
        else:
            out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def moved_bytes(func, args, kwargs, outs) -> int:
    """The bytes an op reads and writes, each tensor once: its inputs and
    outputs. An op that writes into an argument in place (``add_``,
    ``copy_``, ``index_copy_``) reads its other inputs and reads and
    writes the part of the argument it can reach: the smaller of the
    argument and its largest other input (all of it with none)."""
    written = [a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write]
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    mutated = [named[n] for n in written
               if isinstance(named.get(n), torch.Tensor)]
    if not mutated:
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        return sum(_nbytes(t) for t in ins + outs)
    others = [t for t in pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)
              and not any(t is m for m in mutated)]
    reach = max((_nbytes(t) for t in others), default=None)
    return sum(_nbytes(t) for t in others) + sum(
        2 * (_nbytes(m) if reach is None else min(_nbytes(m), reach))
        for m in mutated)


def held_bytes(tree) -> int:
    """Bytes of the distinct storages of the local tensors in ``tree``."""
    seen, n = set(), 0
    for t in pytree.tree_leaves(tree):
        t = getattr(t, "_local_tensor", t)
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
    return n


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of ``world`` ranks (this process is
    rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_meshes(test_mesh: bool, device: str) -> dict:
    """Mesh name -> (world size, a function making the mesh in it)."""
    if test_mesh:
        return {"single": (4, lambda: make_test_mesh(
                    2, 2, device_type=device)),
                "multi": (8, lambda: make_test_mesh(
                    2, 2, pod=2, device_type=device))}
    return {"single": (256, lambda: make_production_mesh(
                multi_pod=False, device_type=device)),
            "multi": (512, lambda: make_production_mesh(
                multi_pod=True, device_type=device))}


# ------------------------------------------------------------- placement
def _fsdp_size(mesh) -> int:
    names = axis_names(mesh)
    n = 1
    for i, a in enumerate(names):
        if a in FSDP_AXES:
            n *= mesh.size(i)
    return n


def _even_batch_specs(spec_tree, mesh):
    """Batch sharding, dropping the constraint when B doesn't divide."""
    fsdp_n = _fsdp_size(mesh)
    fsdp = tuple(a for a in FSDP_AXES if a in axis_names(mesh))

    def one(leaf):
        if leaf.shape and leaf.shape[0] % fsdp_n == 0:
            return P(fsdp, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return tree_map(one, spec_tree)


def _even_cache_specs(cache_shapes, mesh):
    specs = cache_specs(cache_shapes, mesh)
    fsdp_n = _fsdp_size(mesh)

    def fix(spec, leaf):
        # drop batch sharding when the batch dim doesn't divide (long_500k
        # B=1)
        if len(leaf.shape) >= 2 and spec[1] is not None \
                and leaf.shape[1] % fsdp_n != 0:
            parts = list(spec)
            parts[1] = None
            return P(*parts)
        return spec

    return tree_map(fix, specs, cache_shapes)


def _leaves(tree):
    return pytree.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))


def local_fake(like, mesh, spec, mode: TraceMode, device):
    """A DTensor of ``like``'s global shape and type on ``mesh``, placed by
    ``spec``, whose local shard is a new tensor of ``mode`` (on a fake
    mesh only rank 0's shard exists, with torch.chunk's sizes)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    place = placements(spec, mesh, like.dim())
    shape, _ = compute_local_shape_and_global_offset(like.shape, mesh, place)
    with mode:
        local = torch.empty(shape, dtype=like.dtype, device=device)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=like.shape,
                              stride=torch.empty(like.shape,
                                                 device="meta").stride())


def distribute_like(tree, mesh, specs, mode, device):
    return tree_map(lambda t, s: local_fake(t, mesh, s, mode, device), tree,
                    specs)


def serve_step(cfg, kind, mesh, params, inputs, max_seq=None):
    """One sharded prefill or decode step: (logits, cache) DTensors, on a
    mesh whose params are DTensors placed by ``param_specs`` (ZeRO-3, or
    its "inference" mode: "model" only) and whose inputs are DTensors
    placed by ``serve_specs``. The step runs on each rank's own shards
    through ``local_map`` under ``tp.sharded``: tensor-parallel over
    "model", each layer's weights gathered over the FSDP axes while it
    runs where they are ZeRO-3, the batch over the FSDP axes, the cache
    as ``cache_specs`` lays it out (K/V sequence, SSM state heads and the
    convolution tail's channels over "model"). The logits come back whole
    over the vocab. A prefill's cache holds ``max_seq`` positions (the
    prompt's by default). On a one-rank mesh every number is the unsharded
    step's."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed import tp
    leaves = pytree.tree_leaves(params)
    p_place = tuple(tuple(t.placements) for t in leaves)
    modes = {}
    for mode in ("train", "inference"):
        specs = _leaves(param_specs(params, mesh, mode=mode))
        modes[mode] = tuple(placements(sp, mesh, t.ndim)
                            for sp, t in zip(specs, leaves))
    if p_place not in modes.values():
        raise ValueError("serve_step takes parameters placed by "
                         "param_specs (mode 'train' or 'inference')")
    gather = p_place == modes["train"]
    specs = serve_specs(cfg, kind, mesh, inputs, max_seq)

    def place(spec_tree):
        return tuple(placements(sp, mesh) for sp in _leaves(spec_tree))
    if kind == "prefill":
        args, in_specs = (params, inputs), specs["inputs"]
    else:
        args = (params, inputs["cache"], inputs["tokens"])
        in_specs = (specs["cache"], specs["inputs"]["tokens"])

    def run(p, *rest):
        with tp.sharded(mesh, gather=gather):
            if kind == "prefill":
                return prefill(p, *rest, cfg, max_seq)
            return decode_step(p, *rest, cfg)
    fn = local_map(run, out_placements=place((specs["logits"],
                                              specs["cache"])),
                   in_placements=p_place + place(in_specs),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def serve_specs(cfg, kind, mesh, inputs, max_seq=None) -> dict:
    """The specs of a serve step's ``inputs`` (prefill: the batch; decode:
    the tokens and the cache) and of its logits and cache out: the batch,
    tokens and logits by ``_even_batch_specs``, the cache (of ``max_seq``
    positions after a prefill, the prompt's by default) by
    ``_even_cache_specs`` (the reference's ``cache_specs``, the batch
    replicated where it does not divide)."""
    b = inputs["tokens"].shape[0]
    with FakeTensorMode():
        logits = torch.empty((b, 1, cfg.padded_vocab))
        if kind == "prefill":
            s = inputs["tokens"].shape[1]
            s += cfg.n_patches if cfg.family == "vlm" else 0
            cache = cache_spec(cfg, b, max_seq or s, device="cpu")
    if kind == "prefill":
        specs = _even_batch_specs(inputs, mesh)
        cache = _even_cache_specs(cache, mesh)
    else:
        cache = _even_cache_specs(inputs["cache"], mesh)
        specs = {"tokens": _even_batch_specs(inputs["tokens"], mesh),
                 "cache": cache}
    return {"inputs": specs, "cache": cache,
            "logits": _even_batch_specs(logits, mesh)}


# ------------------------------------------------------------------ cells
def cell_config(arch: str, *, remat=None, param_dtype=None, kv_dtype=None,
                carry_cache=False, moe_dispatch=None, seq_shard=False):
    """The cell's config with the reference's overrides applied."""
    cfg = get_config(arch)
    repl = {}
    if remat is not None:
        repl["remat"] = remat
    if param_dtype is not None:
        repl["param_dtype"] = param_dtype
    if kv_dtype is not None:
        repl["kv_dtype"] = kv_dtype
    if carry_cache:
        repl["decode_carry_cache"] = True
    if moe_dispatch is not None:
        repl["moe_dispatch"] = moe_dispatch
    if seq_shard:
        repl["seq_shard"] = True
    return dataclasses.replace(cfg, **repl) if repl else cfg


def params_shape(cfg):
    """The parameter tree as fake CPU tensors: ``init_params`` traced
    under a fake mode (the counterpart of the reference's
    ``eval_shape(init)``; the draws make no numbers)."""
    with FakeTensorMode():
        return init_params(cfg, device="cpu")


def trace_cell(cfg, shape, mesh, *, device="cuda", optimizer="adamw",
               infer_tp=False, microbatches=1) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh``
    over a fake or real process group) on fake tensors. Returns the step
    kind, FLOPs, bytes, collectives and memory of this rank."""
    from torch.utils.flop_counter import FlopCounterMode
    kind, spec = input_specs(cfg, shape, device="cpu")
    p_shapes = params_shape(cfg)
    p_mode = "train"
    if infer_tp and kind != "train":
        names = axis_names(mesh)
        model_n = mesh.size(names.index(MODEL_AXIS)) \
            if MODEL_AXIS in names else 1
        if tree_bytes(p_shapes) / model_n / GIB <= 8.0:
            p_mode = "inference"
    mode = TraceMode()
    with axis_rules(mesh):
        params = distribute_like(p_shapes, mesh,
                                 param_specs(p_shapes, mesh, mode=p_mode),
                                 mode, device)
        if kind == "train":
            opt = make_optimizer(optimizer)
            step = make_train_step(cfg, opt, microbatches=microbatches,
                                   mesh=mesh)
            with mode:
                opt_state = opt.init(tree_map(lambda t: t.to_local(),
                                              params))
            batch = distribute_like(spec, mesh, _even_batch_specs(spec, mesh),
                                    mode, device)
            args = (params, opt_state, batch)
            alias = held_bytes((params, opt_state))
        else:
            inputs = distribute_like(
                spec, mesh, serve_specs(cfg, kind, mesh, spec)["inputs"],
                mode, device)
            # decode writes the cache in place, all but its position
            alias = 0 if kind == "prefill" else held_bytes(
                inputs["cache"]) - held_bytes(inputs["cache"]["pos"])
            args = (params, inputs)
        arg_b = held_bytes(args)
        mode.reset()
        flops = FlopCounterMode(display=False)
        colls = CollectiveCounter()
        with mode, flops, colls:
            if kind == "train":
                out = step(*args)
            else:
                out = serve_step(cfg, kind, mesh, *args)
        out_b = held_bytes((args, out)) - held_bytes(args)
        moved, peak = mode.moved, mode.peak
        del out, args
    return {"kind": kind, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(moved), "collectives": colls.result(),
            "memory": {"argument_gb": arg_b / GIB, "output_gb": out_b / GIB,
                       "temp_gb": (peak - arg_b) / GIB,
                       "alias_gb": alias / GIB, "peak_gb": peak / GIB}}


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, *,
             device="cuda", optimizer="adamw", infer_tp=False,
             microbatches=1, **cfg_kw) -> dict:
    """Trace and analyse one cell; returns a JSON-serializable row."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, **cfg_kw)
    ok, reason = cell_is_applicable(get_config(arch), shape)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": mesh.size()}
    if not ok:
        row.update(status="skipped", reason=reason)
        return row
    t0 = time.time()
    got = trace_cell(cfg, shape, mesh, device=device, optimizer=optimizer,
                     infer_tp=infer_tp, microbatches=microbatches)
    t_trace = time.time() - t0
    coll = got["collectives"]
    report = roofline_terms(arch, shape, cfg, mesh_name, mesh.size(),
                            got["flops"], got["bytes_accessed"],
                            float(coll["total_bytes"]),
                            peak_memory_gb=got["memory"]["peak_gb"])
    row.update(
        status="ok", kind=got["kind"], device=device,
        trace_s=round(t_trace, 2), memory=got["memory"],
        cost={"flops": got["flops"], "bytes_accessed": got["bytes_accessed"],
              "collective_bytes": float(coll["total_bytes"])},
        collectives=coll, roofline=dataclasses.asdict(report))
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--optimizer", default="adamw",
                    help="the sharded step takes adamw (elementwise)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--param-dtype", default=None,
                    help="e.g. bfloat16: halves FSDP weight collectives")
    ap.add_argument("--kv-dtype", default=None,
                    help="e.g. float8_e4m3fn: halves decode KV HBM")
    ap.add_argument("--carry-cache", action="store_true",
                    help="decode cache updated in place (the port's "
                         "default; changes no number)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "flat", "rowwise", "grouped"],
                    help="rowwise: per-sequence position-in-expert cumsum")
    ap.add_argument("--infer-tp", action="store_true",
                    help="TP-only weights for prefill/decode cells")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence parallelism (cfg.seq_shard): the "
                         "residual stream each 'model' rank's slice of the "
                         "sequence in the train and prefill cells")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation splits (train cells)")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--tag", default="",
                    help="experiment tag copied into every row")
    ap.add_argument("--test-mesh", action="store_true",
                    help="scaled-down meshes: (2, 2) and (2, 2, 2)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fake tensors live: cuda runs K4-K6's "
                         "fake kernels, cpu their plain versions")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = make_meshes(args.test_mesh, args.device)
    if args.mesh != "both":
        meshes = {args.mesh: meshes[args.mesh]}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_fail = 0
    t_all = time.time()
    with open(args.out, "a") as f:
        for mesh_name, (world, make) in meshes.items():
            with fake_world(world):
                mesh = make()
                for arch in archs:
                    for shape_name in shapes:
                        t0 = time.time()
                        try:
                            row = run_cell(
                                arch, shape_name, mesh, mesh_name,
                                device=args.device, optimizer=args.optimizer,
                                infer_tp=args.infer_tp,
                                microbatches=args.microbatches,
                                remat=args.remat,
                                param_dtype=args.param_dtype,
                                kv_dtype=args.kv_dtype,
                                carry_cache=args.carry_cache,
                                moe_dispatch=args.moe_dispatch,
                                seq_shard=args.seq_shard)
                        except Exception as e:  # noqa: BLE001 (isolation)
                            row = {"arch": arch, "shape": shape_name,
                                   "mesh": mesh_name, "status": "error",
                                   "error": f"{type(e).__name__}: {e}",
                                   "traceback":
                                       traceback.format_exc()[-2000:]}
                        row["wall_s"] = round(time.time() - t0, 2)
                        if args.tag:
                            row["tag"] = args.tag
                        f.write(json.dumps(row) + "\n")
                        f.flush()
                        status = row["status"]
                        n_ok += status == "ok"
                        n_skip += status == "skipped"
                        n_fail += status == "error"
                        bn = row.get("roofline", {}).get("bottleneck", "-")
                        peak = row.get("memory", {}).get("peak_gb", 0.0)
                        print(f"[{mesh_name:6s}] {arch:22s} {shape_name:12s} "
                              f"{status:8s} {row['wall_s']:7.1f}s "
                              f"peak={peak:7.2f}GB bottleneck={bn}",
                              flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed in "
          f"{time.time() - t_all:.1f} s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
