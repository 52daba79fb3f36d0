"""Tensor parallelism over "model" and per-layer weight gathering over the
FSDP axes, on each rank's own shards.

The reference's train step is ``jit`` with ``in_shardings`` from
``param_specs``, and its models carry ``with_sharding_constraint``
annotations (heads, ``ff``, ``vocab`` and ``ssm_heads`` over "model"):
under GSPMD that is Megatron-style tensor parallelism over "model", with
the FSDP dims ("pod", "data") of each weight gathered where it is used.
Here the same layout is written out on local tensors. The sharded step
(``train.step``) and the serve steps (``launch.dryrun.serve_step``) run
the model inside ``local_map`` on each parameter's own shard under
``sharded(mesh)``, and the models call the functions below; with no
``sharded`` context, or on groups of one rank, every function returns its
argument's own numbers (no collective, no copy).

  * ``gather_layer(tree)``: each leaf's FSDP dim all-gathered (an autograd
    all-gather whose backward reduce-scatters the gradient); a leaf with no
    FSDP dim passes as it is, its gradient all-reduced over the FSDP axes.
    The models call it inside the layer's recompute function, so the
    gathered weights of a layer live only while the layer runs and are
    gathered again for its backward;
  * ``copy_to_tp`` (identity forward, all-reduce backward) and
    ``reduce_from_tp`` (all-reduce forward, identity backward): Megatron's
    pair around a column-parallel and a row-parallel product; with
    ``seq=True`` (``cfg.seq_shard``, Megatron's sequence parallelism) the
    residual stream between them is each rank's slice of the sequence:
    ``copy_to_tp`` gathers the slices (forward; reduce-scatter backward)
    and ``reduce_from_tp`` reduce-scatters the partial sums onto them
    (forward; gather backward), each an all-to-all (``_gather_seq``,
    ``_scatter_seq``); ``use_once`` counts once the gradient of a value
    every rank computes alike (the MoE load-balance loss), and
    ``check_seq`` refuses a sequence that does not split;
  * ``take`` / ``take_replicated``: the rank's columns of a "model"-sharded
    or replicated weight when they are not its own shard (whole heads, a
    KV head shared by neighbouring ranks, Mamba2's packed projection),
    exchanged by an all-to-all whose backward sends each gradient piece
    back to its owner and sums it there;
  * ``embed_lookup``, ``vocab_offset``, ``vocab_cross_entropy``: the
    vocab-parallel embedding (mask and all-reduce) and cross-entropy (the
    max and the sum of exponentials over "model", the label's logit from
    its owner); the whole-vocab logits never exist on a rank;
  * ``rmsnorm``: Mamba2's gated norm over all of ``d_inner``, its sum of
    squares all-reduced over "model";
  * for prefill and decode (``launch.dryrun.serve_step``), the cache laid
    out as the reference's ``cache_specs`` lays it out: ``kv_to_cache``
    sends a prompt's K/V from each rank's KV heads to every rank's slice
    of the sequence, ``conv_to_cache`` / ``conv_from_cache`` /
    ``conv_step`` move Mamba2's convolution tail between the channels a
    rank computes and the chunk of channels it caches (exchanged at every
    step: the tail is (K - 1) x (d_inner + 2N) a sequence, a few KB, where
    keeping the rank's own channels would hold B and C on every rank and
    leave the cache's layout), ``gather_heads`` gives every rank the
    step's query heads and new K/V, ``write_at`` writes them on the rank
    that owns ``pos``, ``merge_heads`` sends each slice's attention and
    log-sum-exp to the rank of each head and adds them there in rank
    order, and ``gather_vocab`` returns whole-vocab logits. Every exchange
    is one all-to-all (``regroup``); the card's gloo crashed in an
    all-gather of CUDA tensors.

Which split each config takes on the production meshes' 16 "model" ranks
(``head_split``, ``attention_shard``): every config's query heads divide
16 (a rank's columns of ``wq`` and rows of ``wo`` are its own shard)
but qwen1.5-32b's 40, which splits 2 or 3 whole heads a rank and takes
the straddling columns from a neighbour. KV heads: qwen1.5-32b, zamba2-7b
and musicgen-large have one per query head (the rank's own); granite-3-2b,
minitron-8b and phi3.5-moe have 8 (the reference's spec splits a head
over two ranks: each computes the whole head its 2 query heads use,
local G 2 against 4), yi-9b 4 (one head over four ranks, local G 2 against
8), internvl2-26b and grok-1-314b 8 against 48 query heads (3 a rank, one
KV head, local G 3 against 6). Mamba2's 48 (mamba2-780m) and 112
(zamba2-7b) heads split 3 and 7 a rank; its ``in_proj`` columns are split
in contiguous chunks that do not line up with heads, so every rank takes
its heads' z, x and dt columns and all of B and C (``ssm_shard``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import torch

from repro_torch.distributed.sharding import (FSDP_AXES, MODEL_AXIS,
                                              _spec_for_path, axis_names)

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it and the process group of the ranks that differ only there."""
    name: str
    size: int
    rank: int
    group: object


@dataclasses.dataclass(frozen=True)
class _Context:
    model: _Axis | None             # None: no "model" axis of size > 1
    fsdp: tuple[_Axis, ...]         # the FSDP axes of size > 1, mesh order
    fsdp_names: tuple[str, ...]     # every FSDP axis of the mesh
    gather: bool = True             # the weights carry FSDP dims (ZeRO-3)


def _ctx() -> _Context | None:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def _use(ctx: _Context | None):
    prev = _ctx()
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def sharded(mesh, gather: bool = True):
    """Run the enclosed model code on this rank's shards of ``mesh``: the
    weights placed by ``param_specs`` (ZeRO-3, ``gather`` True: each
    layer's FSDP dims gathered while it runs) or by its "inference" mode
    (``gather`` False: sharded over "model" only, nothing gathered)."""
    names = axis_names(mesh)

    def axis(name):
        return _Axis(name, mesh.size(names.index(name)),
                     mesh.get_local_rank(name), mesh.get_group(name))
    model = axis(MODEL_AXIS) if MODEL_AXIS in names \
        and mesh.size(names.index(MODEL_AXIS)) > 1 else None
    fsdp = tuple(axis(a) for a in names
                 if a in FSDP_AXES and mesh.size(names.index(a)) > 1)
    with _use(_Context(model, fsdp,
                       tuple(a for a in names if a in FSDP_AXES), gather)):
        yield


def carried(fn):
    """``fn`` run under the ``sharded`` context active now, from whatever
    thread calls it: a layer's recompute runs in the backward, on the
    autograd engine's thread for the card's tensors, where this thread's
    context is not set. ``fn`` itself with no context."""
    ctx = _ctx()
    if ctx is None:
        return fn

    def run(*args):
        with _use(ctx):
            return fn(*args)
    return run


def model_size() -> int:
    """Ranks of the "model" axis computing apart (1 outside ``sharded``)."""
    ctx = _ctx()
    return ctx.model.size if ctx is not None and ctx.model else 1


def model_rank() -> int:
    ctx = _ctx()
    return ctx.model.rank if ctx is not None and ctx.model else 0


def gathers() -> bool:
    """True when a layer's weights are gathered over FSDP ranks (and must
    then be dropped after the layer and gathered again for its
    backward)."""
    ctx = _ctx()
    return ctx is not None and bool(ctx.fsdp) and ctx.gather


# ------------------------------------------------------------ collectives
# The functional collectives' ops themselves (what DTensor issues, and what
# analysis.collectives counts), each waited for at once.
def _c10d():
    return torch.ops._c10d_functional


def _wait(t):
    return _c10d().wait_tensor(t)


def _all_reduce(x, op, group):
    return _wait(_c10d().all_reduce(x.contiguous(), op, group.group_name))


def _all_gather(x, dim, group):
    """``x`` of every rank of ``group`` concatenated along ``dim``."""
    out = _wait(_c10d().all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), group.size(), group.group_name))
    return out.movedim(0, dim)


def _reduce_scatter(x, dim, group):
    """The sum over ``group`` of ``x``, this rank's chunk along ``dim``."""
    out = _wait(_c10d().reduce_scatter_tensor(
        x.movedim(dim, 0).contiguous(), "sum", group.size(),
        group.group_name))
    return out.movedim(0, dim)


def _all_to_all(x, outs, ins, group):
    return _wait(_c10d().all_to_all_single(x.contiguous(), outs, ins,
                                           group.group_name))


# The sequence pair (``copy_to_tp``/``reduce_from_tp`` with ``seq``) moves
# activations in all-to-alls only: the card's gloo crashed in an all-gather
# of CUDA tensors, and a reduce-scatter sums each element in an order set by
# the library's algorithm and the element's place in its buffer, where
# here each rank adds the pieces it receives in rank order (as
# ``merge_heads`` does), the same numbers on every backend. Each moves the
# bytes of the all-gather or reduce-scatter it stands for.
def _gather_seq(x, dim, group):
    """``x`` of every rank of ``group`` concatenated along ``dim``: ``x``
    sent to every rank in one all-to-all. Contiguous, for the products it
    feeds."""
    m = group.size()
    x = x.contiguous()
    n = x.shape[0]
    out = _all_to_all(x.unsqueeze(0).expand(m, *x.shape).flatten(0, 1),
                      [n] * m, [n] * m, group)
    return out.unflatten(0, (m, n)).movedim(0, dim).flatten(dim, dim + 1)


def _scatter_seq(x, dim, group):
    """The sum over ``group`` of ``x``, this rank's chunk along ``dim``:
    chunk t sent to rank t in one all-to-all, the chunks received added in
    rank order."""
    m = group.size()
    parts = x.unflatten(dim, (m, -1)).movedim(dim, 0)
    n = parts.shape[1]
    got = _all_to_all(parts.flatten(0, 1), [n] * m, [n] * m,
                      group).unflatten(0, (m, n))
    out = got[0].clone()
    for r in range(1, m):
        out += got[r]
    return out


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = _all_reduce(g, "sum", group)
        return g, None


class _Reduce(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient as it is (``back`` False:
    the sum is used alike on every rank) or summed too (``back`` True: each
    rank uses it for its own part)."""

    @staticmethod
    def forward(ctx, x, group, back):
        ctx.group, ctx.back = group, back
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, "sum", ctx.group) if ctx.back else g,
                None, None)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Seq(torch.autograd.Function):
    """The sequence pair along ``dim``: the gather (``gather`` True) or
    the reduce-scatter forward, the other backward."""

    @staticmethod
    def forward(ctx, x, dim, group, gather):
        ctx.dim, ctx.group, ctx.gather = dim, group, gather
        return (_gather_seq if gather else _scatter_seq)(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        back = _scatter_seq if ctx.gather else _gather_seq
        return back(g, ctx.dim, ctx.group), None, None, None


class _Once(torch.autograd.Function):
    """Identity forward; the gradient on "model" rank 0, zero on the
    others."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def copy_to_tp(x, seq: bool = False):
    """Enter a tensor-parallel region: ``x`` as it is, its gradient summed
    over "model" (each rank's products add to it). With ``seq`` (Megatron's
    sequence parallelism, ``cfg.seq_shard``) ``x`` (B, S / model, ...) is
    the rank's slice of the sequence: every rank's slice gathered along
    dim 1, the gradient reduce-scattered back onto the slice."""
    ctx = _ctx()
    if ctx is None or ctx.model is None:
        return x
    if seq:
        return _Seq.apply(x, 1, ctx.model.group, True)
    return _Copy.apply(x, (ctx.model.group,))


def reduce_from_tp(x, seq: bool = False):
    """Leave a tensor-parallel region: the ranks' partial sums added over
    "model"; the gradient as it is. With ``seq``, only this rank's slice
    of the sequence (dim 1) of the sum (a reduce-scatter), the gradient
    gathered along the sequence."""
    ctx = _ctx()
    if ctx is None or ctx.model is None:
        return x
    if seq:
        return _Seq.apply(x, 1, ctx.model.group, False)
    return _Reduce.apply(x, ctx.model.group, False)


def use_once(x):
    """``x``, which every "model" rank computes alike, where the gradients
    around it are each rank's part of a sum over "model" (the MoE
    load-balance loss under ``cfg.seq_shard``): its gradient kept on rank
    0 only, so that the sum adds it once. ``x`` itself with no "model"
    ranks."""
    ctx = _ctx()
    if ctx is None or ctx.model is None:
        return x
    return _Once.apply(x, ctx.model.rank == 0)


def check_seq(s: int) -> None:
    """Refuse a sequence of ``s`` positions that does not split evenly
    over the "model" ranks (under ``cfg.seq_shard``)."""
    m = model_size()
    if s % m:
        raise ValueError(f"seq_shard: a sequence of {s} positions does not "
                         f"split over {m} 'model' ranks")


def _fsdp_dim(name: str, t, ctx: _Context):
    """(dim, FSDP axes sharding it, innermost first) of a leaf, from its
    name as ``param_specs`` places it, or (None, ()) for none."""
    fsdp = ctx.fsdp_names
    spec = _spec_for_path(name, t.dim(), fsdp[0] if len(fsdp) == 1
                          else fsdp or None, MODEL_AXIS)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        along = [a for a in ctx.fsdp if a.name in axes]
        if along:
            return d, along[::-1]
    return None, ()


def gather_layer(tree):
    """A layer's parameters with their FSDP dims gathered: a new tree of
    the same keys. Differentiable: each gathered leaf's gradient is
    reduce-scattered back onto its shard, each other leaf's all-reduced
    over the FSDP axes. The tree itself with no FSDP ranks."""
    ctx = _ctx()
    if ctx is None or not ctx.fsdp or not ctx.gather:
        return tree

    def one(name, t):
        dim, along = _fsdp_dim(name, t, ctx)
        if dim is None:
            return _Copy.apply(t, tuple(a.group for a in ctx.fsdp))
        for axis in along:
            t = _Gather.apply(t, dim, axis.group)
        return t

    return {k: gather_layer(v) if isinstance(v, dict) else one(k, v)
            for k, v in tree.items()}


def copies(t) -> int:
    """How many ranks of its mesh hold each element of DTensor ``t``: the
    product of the sizes of the mesh dims it is replicated over."""
    from torch.distributed.tensor import Replicate
    n = 1
    for dim, place in enumerate(t.placements):
        if isinstance(place, Replicate):
            n *= t.device_mesh.size(dim)
    return n


def mesh_sum(x, mesh):
    """The sum of ``x`` over every rank of ``mesh`` (an all-reduce over
    each of its dims of more than one rank); ``x`` itself on one rank."""
    for dim, name in enumerate(axis_names(mesh)):
        if mesh.size(dim) > 1:
            x = _all_reduce(x, "sum", mesh.get_group(name))
    return x


def batch_mean(x):
    """The mean over the FSDP ranks of ``x``, a mean over this rank's batch
    shard: the global batch's mean (the reference takes the router's load
    statistics over its whole, sharded batch). Each rank's gradient is the
    sum of every rank's use. ``x`` itself with no FSDP ranks."""
    ctx = _ctx()
    if ctx is None or not ctx.fsdp:
        return x
    n = 1
    for axis in ctx.fsdp:
        x = _Reduce.apply(x, axis.group, True)
        n *= axis.size
    return x / n


# ------------------------------------------------- columns of other ranks
def _pieces(needs, shard: int, owner: int):
    """The parts of ``needs`` (sorted (lo, hi) ranges) that rank ``owner``
    holds, as (lo, hi) ranges of global index."""
    lo_s, hi_s = owner * shard, (owner + 1) * shard
    return [(max(lo, lo_s), min(hi, hi_s)) for lo, hi in needs
            if max(lo, lo_s) < min(hi, hi_s)]


def _width(ranges) -> int:
    return sum(hi - lo for lo, hi in ranges)


class _Take(torch.autograd.Function):
    """The ranges of a "model"-sharded dim that each rank needs, exchanged
    by one all-to-all (dim first); backward the reverse exchange, each
    owner summing the pieces it gets back."""

    @staticmethod
    def forward(ctx, w, dim, plan, me, group):
        shard = w.shape[dim]
        wt = w.movedim(dim, 0)
        sends = [wt[lo - me * shard: hi - me * shard]
                 for r in range(len(plan)) for lo, hi in plan[r][me]]
        ins = [_width(plan[r][me]) for r in range(len(plan))]
        outs = [_width(plan[me][s]) for s in range(len(plan))]
        got = _all_to_all(torch.cat(sends) if sends else wt[:0], outs, ins,
                          group)
        ctx.dim, ctx.plan, ctx.me, ctx.group = dim, plan, me, group
        ctx.shard, ctx.ins, ctx.outs = shard, ins, outs
        return got.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        back = _all_to_all(g.movedim(ctx.dim, 0), ctx.ins, ctx.outs,
                           ctx.group)
        grad = back.new_zeros((ctx.shard, *back.shape[1:]))
        at, me = 0, ctx.me
        for r in range(len(ctx.plan)):
            for lo, hi in ctx.plan[r][me]:
                grad[lo - me * ctx.shard: hi - me * ctx.shard] += \
                    back[at: at + hi - lo]
                at += hi - lo
        return grad.movedim(0, ctx.dim), None, None, None, None


def take(w, dim: int, needs: list):
    """The columns ``needs[r]`` (sorted, disjoint (lo, hi) ranges of global
    index) of ``w``'s dim ``dim``, sharded evenly over "model", for this
    rank r, concatenated in order. Its own shard's columns are sliced
    locally; when any rank needs another's, every rank joins one
    all-to-all (``_Take``). ``needs`` lists every rank's ranges, so each
    rank plans the same exchange."""
    ctx = _ctx()
    dim = dim % w.dim()
    shard, me = w.shape[dim], ctx.model.rank
    plan = [[_pieces(needs[r], shard, s) for s in range(len(needs))]
            for r in range(len(needs))]
    if all(_width(plan[r][r]) == _width(needs[r]) for r in range(len(plan))):
        if needs[me] == [(me * shard, (me + 1) * shard)]:
            return w
        return torch.cat([w.narrow(dim, lo - me * shard, hi - lo)
                          for lo, hi in needs[me]], dim)
    return _Take.apply(w, dim, plan, me, ctx.model.group)


def take_replicated(p, dim: int, ranges: list):
    """The columns ``ranges`` of a weight every rank holds whole, used in a
    tensor-parallel region: the gradient of each rank's columns summed
    over "model"."""
    ctx = _ctx()
    p = _Copy.apply(p, (ctx.model.group,))
    return torch.cat([p.narrow(dim % p.dim(), lo, hi - lo)
                      for lo, hi in ranges], dim)


# ----------------------------------------------------------------- heads
def head_split(n_heads: int, n_kv: int, m: int) -> list:
    """Each of ``m`` "model" ranks' ((h0, h1), (k0, k1)): the whole query
    heads it computes, n_heads / m each (2 or 3 for 40 over 16), and the
    KV heads they use. Raises where a rank's query heads would group
    unevenly over its KV heads (10 heads on 5 KV heads over 4 ranks: 3
    query heads on 2 KV heads), which no config's mesh gives."""
    if n_heads < m:
        raise ValueError(f"{n_heads} heads cannot be split over {m} "
                         f"'model' ranks")
    g = n_heads // n_kv
    heads = [(r * n_heads // m, (r + 1) * n_heads // m) for r in range(m)]
    split = [((h0, h1), (h0 // g, (h1 - 1) // g + 1)) for h0, h1 in heads]
    for (h0, h1), (k0, k1) in split:
        per_kv = {sum(h // g == k for h in range(h0, h1))
                  for k in range(k0, k1)}
        if len(per_kv) > 1:
            raise ValueError(f"{n_heads} query heads on {n_kv} KV heads "
                             f"group unevenly over {m} 'model' ranks")
    return split


def attention_shard(params, n_heads: int, n_kv: int, head_dim: int):
    """The layer's attention weights for this rank's query heads and the
    KV heads they use: ``wq``/``bq`` columns and ``wo`` rows of the rank's
    whole heads; ``wk``/``wv``/``bk``/``bv`` columns of its KV heads,
    whole (two neighbours that share a KV head both compute it; its
    gradient is summed at its owners). ``params`` itself without TP."""
    if model_size() == 1:
        return params
    d = head_dim
    split = head_split(n_heads, n_kv, model_size())
    q_cols = [[(h0 * d, h1 * d)] for (h0, h1), _ in split]
    kv_cols = [[(k0 * d, k1 * d)] for _, (k0, k1) in split]
    me = model_rank()
    out = {"wq": take(params["wq"], -1, q_cols),
           "wk": take(params["wk"], -1, kv_cols),
           "wv": take(params["wv"], -1, kv_cols),
           "wo": take(params["wo"], -2, q_cols)}
    for name, cols in (("bq", q_cols), ("bk", kv_cols), ("bv", kv_cols)):
        if name in params:
            out[name] = take_replicated(params[name], -1, cols[me])
    return out


def ssm_shard(params, d_inner: int, n_state: int, n_heads: int):
    """(the layer's Mamba2 weights for this rank's heads, its number of
    heads). ``in_proj``'s packed (z, x, B, C, dt) columns are cut to the
    rank's heads' z, x and dt and all of B and C, in that order;
    ``conv_w``/``conv_b`` to its x channels and all of B and C;
    ``norm_scale`` to its x channels; ``a_log``, ``dt_bias``, ``ssm_d``
    and ``out_proj``'s rows are its own shard. Without TP:
    ``(params, n_heads)``."""
    m = model_size()
    if m == 1:
        return params, n_heads
    if n_heads % m:
        raise ValueError(f"{n_heads} Mamba2 heads do not split over {m} "
                         f"'model' ranks")
    di, n, w = d_inner, n_state, d_inner // m
    z = [(r * w, (r + 1) * w) for r in range(m)]
    x = [(di + lo, di + hi) for lo, hi in z]
    hl = n_heads // m
    dt = [(2 * di + 2 * n + r * hl, 2 * di + 2 * n + (r + 1) * hl)
          for r in range(m)]
    bc = (2 * di, 2 * di + 2 * n)
    me = model_rank()
    conv = [[z[r], (di, di + 2 * n)] for r in range(m)]
    out = dict(params)
    out["in_proj"] = take(params["in_proj"], -1,
                          [[z[r], x[r], bc, dt[r]] for r in range(m)])
    out["conv_w"] = take(params["conv_w"], -1, conv)
    out["conv_b"] = take_replicated(params["conv_b"], -1, conv[me])
    out["norm_scale"] = take_replicated(params["norm_scale"], -1, [z[me]])
    return out, hl


# ----------------------------------------------------------------- vocab
def embed_lookup(table, tokens, prefix=None, seq: bool = False):
    """``table[tokens]``, after ``prefix`` (B, P, d) along the sequence
    where given; under TP ``table`` is the rank's rows of the vocab: the
    rows it owns looked up, the others zero, summed over "model" (each
    token's row comes from its owner, exactly). With ``seq`` the sum is
    reduce-scattered onto this rank's slice of the sequence, ``prefix``
    added in by rank 0 alone."""
    def after(rows):
        return rows if prefix is None else torch.cat([prefix, rows], 1)
    if model_size() == 1:
        return after(table[tokens])
    v = table.shape[0]
    local = tokens - model_rank() * v
    inside = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    if not seq:
        return after(reduce_from_tp(rows))
    if prefix is not None and model_rank():
        prefix = torch.zeros_like(prefix)
    return reduce_from_tp(after(rows), seq=True)


def vocab_offset(local_vocab: int) -> int:
    """The first vocab index of this rank's logits columns."""
    return model_rank() * local_vocab


def vocab_cross_entropy(logits, labels, mask):
    """``layers.cross_entropy`` on vocab-parallel logits (B, S, V / model):
    log Z from the max and the sum of exponentials over "model", the
    label's logit from the rank that holds it."""
    ctx = _ctx()
    v = logits.shape[-1]
    m = _all_reduce(logits.detach().amax(-1), "max", ctx.model.group)
    total = reduce_from_tp(torch.sum(torch.exp(logits - m[..., None]), -1))
    local = labels.long() - vocab_offset(v)
    inside = (local >= 0) & (local < v)
    pick = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    pick = reduce_from_tp(torch.where(inside, pick, torch.zeros_like(pick)))
    ll = pick - m - torch.log(total)
    if mask is None:
        return -torch.mean(ll)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return -torch.sum(ll * mask) / denom


# ------------------------------------------------------------------ norms
def rmsnorm(x, scale, eps: float = 1e-6):
    """``layers.rmsnorm`` over a dim split over "model" (``x`` and
    ``scale`` the rank's columns): the mean square of all of it."""
    from repro_torch.models.layers import rmsnorm as whole
    ctx = _ctx()
    if ctx is None or ctx.model is None:
        return whole(x, scale, eps)
    x32 = x.float()
    ss = _Reduce.apply(torch.sum(x32 * x32, dim=-1, keepdim=True),
                       ctx.model.group, True)
    y = x32 * torch.rsqrt(ss / (x.shape[-1] * ctx.model.size) + eps)
    return (y * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- serve
# Prefill and decode lay the cache out as the reference's ``cache_specs``
# does: K/V sequence over "model" (rank r holds the positions r * S_loc ..
# (r + 1) * S_loc - 1), Mamba2's state heads over "model" (a rank's own
# heads) and the convolution tail's channels over "model" in contiguous
# chunks (``chunk_ranges``). Tensors are exchanged with all-to-alls only
# (the card's gloo crashed in an all-gather of CUDA tensors); a piece a
# rank holds itself never goes through the collective.
def chunk_ranges(n: int, m: int) -> list:
    """Each of ``m`` ranks' (lo, hi) of a dim of ``n`` split as
    ``torch.chunk`` (and a DTensor ``Shard``) splits it: ceil(n / m) each,
    the last ones short or empty."""
    c = -(-n // m)
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(m)]


def chunk_width(n: int) -> int:
    """This rank's share of a dim of ``n`` sharded over "model"."""
    lo, hi = chunk_ranges(n, model_size())[model_rank()]
    return hi - lo


def _exchange(sends, shapes, group):
    """One all-to-all: ``sends[t]`` (a tensor) to rank t, and back the
    tensor of shape ``shapes[s]`` that rank s sent here, for every s, in
    the sends' type (moved as bytes: gloo carries no e4m3)."""
    dtype = sends[0].dtype
    size = torch.empty((), dtype=dtype).element_size()
    flat = torch.cat([t.reshape(-1) for t in sends]).view(torch.uint8)
    outs = [size * _numel(sh) for sh in shapes]
    got = _all_to_all(flat, outs, [size * t.numel() for t in sends], group)
    return [g.view(dtype).reshape(sh)
            for g, sh in zip(got.split(outs), shapes)]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _holder(idx: int, have, me: int) -> int:
    """Who supplies global index ``idx``: this rank where it holds it,
    else the lowest rank that does."""
    def holds(r):
        return any(lo <= idx < hi for lo, hi in have[r])
    if holds(me):
        return me
    for r in range(len(have)):
        if holds(r):
            return r
    raise ValueError(f"no rank holds index {idx}")


@functools.lru_cache(maxsize=256)
def _regroup_plan(have, need):
    """Every rank's needed ranges cut into (supplier, lo, hi) pieces, in
    order: a supplier's pieces lie in one of its held ranges."""
    cuts = sorted({e for ranges in have for r in ranges for e in r})
    plan = []
    for t, ranges in enumerate(need):
        pieces = []
        for lo, hi in ranges:
            edges = [lo] + [c for c in cuts if lo < c < hi] + [hi]
            for a, b in zip(edges, edges[1:]):
                if a < b:
                    pieces.append((_holder(a, have, t), a, b))
        plan.append(pieces)
    return plan


def _local(ranges, lo: int) -> int:
    """The position of global index ``lo`` in a tensor holding ``ranges``
    concatenated."""
    at = 0
    for a, b in ranges:
        if a <= lo < b:
            return at + lo - a
        at += b - a
    raise ValueError(f"index {lo} is not held")


def regroup(x, dim: int, have: list, need: list):
    """The global indices ``need[me]`` (sorted (lo, hi) ranges) of a dim
    whose indices ``have[r]`` each rank r holds (``x`` holding this rank's,
    concatenated along ``dim``), concatenated in order: each index from
    this rank where it holds it, else from the lowest rank that does, in
    one all-to-all (none where every rank holds all it needs)."""
    ctx = _ctx()
    me, m = ctx.model.rank, ctx.model.size
    dim = dim % x.dim()
    plan = _regroup_plan(tuple(tuple(map(tuple, h)) for h in have),
                         tuple(tuple(map(tuple, n)) for n in need))

    def piece(lo, hi):
        return x.narrow(dim, _local(have[me], lo), hi - lo)
    remote = any(s != t for t in range(m) for s, _, _ in plan[t])
    if not remote:
        return torch.cat([piece(lo, hi) for _, lo, hi in plan[me]]
                         or [x.narrow(dim, 0, 0)], dim)
    xt = x.movedim(dim, 0)
    rest = tuple(xt.shape[1:])

    def part(t):
        got = [piece(lo, hi).movedim(dim, 0) for s, lo, hi in plan[t]
               if s == me and t != me]
        return torch.cat(got) if got else xt[:0]
    widths = [sum(hi - lo for s, lo, hi in plan[me] if s == r and r != me)
              for r in range(m)]
    got = _exchange([part(t) for t in range(m)],
                    [(w, *rest) for w in widths], ctx.model.group)
    at = [0] * m
    out = []
    for s, lo, hi in plan[me]:
        if s == me:
            out.append(piece(lo, hi))
        else:
            out.append(got[s][at[s]: at[s] + hi - lo].movedim(0, dim))
            at[s] += hi - lo
    return torch.cat(out or [x.narrow(dim, 0, 0)], dim)


def gather_heads(x, n_heads: int, n_kv: int, kv: bool = False):
    """All heads of ``x`` (B, S, heads, ...) from each rank's query heads
    (``kv`` False) or KV heads (``kv`` True) of ``head_split``; a KV head
    that several ranks compute comes from its lowest one."""
    split = head_split(n_heads, n_kv, model_size())
    have = [[kk if kv else hh] for hh, kk in split]
    return regroup(x, 2, have, [[(0, n_kv if kv else n_heads)]] * len(split))


def gather_vocab(logits):
    """The whole vocab of vocab-parallel logits (B, S, V / model)."""
    if model_size() == 1:
        return logits
    v = logits.shape[-1]
    m = model_size()
    return regroup(logits, -1, [[(r * v, (r + 1) * v)] for r in range(m)],
                   [[(0, m * v)]] * m)


def seq_offset(s_loc: int) -> int:
    """The first cache position of this rank's sequence slice."""
    return model_rank() * s_loc


def kv_to_cache(k, v, k_cache, v_cache, n_heads: int, n_kv: int) -> None:
    """Write a prompt's K and V (B, s, heads, D) into one layer's cache
    (B, S_loc, Hkv, D) in place. Under TP ``k``/``v`` are this rank's KV
    heads (``head_split``) and the cache its sequence slice: each KV head
    goes from its lowest rank to every rank's slice of the prompt, in one
    all-to-all of both."""
    s = k.shape[1]
    m = model_size()
    if m == 1:
        k_cache[:, :s] = k
        v_cache[:, :s] = v
        return
    me, s_loc = model_rank(), k_cache.shape[1]
    kv_heads = [kk for _, kk in head_split(n_heads, n_kv, m)]
    own, top = [], 0
    for k0, k1 in kv_heads:       # the KV heads each rank sends
        own.append((max(k0, top), max(k1, top)))
        top = max(top, k1)
    both = torch.stack([k, v]).to(k_cache.dtype)       # (2, B, s, Hl, D)
    k0_me = kv_heads[me][0]

    def rows(t):
        return min(t * s_loc, s), min((t + 1) * s_loc, s)

    def part(t):
        if t == me:
            return both[:, :, :0]
        (p0, p1), (h0, h1) = rows(t), own[me]
        return both[:, :, p0:p1, h0 - k0_me: h1 - k0_me]
    p0, p1 = rows(me)
    b, d = k.shape[0], k.shape[3]
    got = _exchange([part(t) for t in range(m)],
                    [(2, b, 0 if r == me else p1 - p0, own[r][1] - own[r][0],
                      d) for r in range(m)], _ctx().model.group)
    got[me] = both[:, :, p0:p1, own[me][0] - k0_me: own[me][1] - k0_me]
    for r in range(m):
        h0, h1 = own[r]
        if h1 > h0 and p1 > p0:
            k_cache[:, :p1 - p0, h0:h1] = got[r][0]
            v_cache[:, :p1 - p0, h0:h1] = got[r][1]


def merge_heads(o, lse, n_heads: int, n_kv: int):
    """Under TP, each rank's attention over its cache slice for every
    head, o (B, 1, H, D) fp32 and lse (B, 1, H), merged for this rank's
    query heads: (B, 1, H_loc, D) fp32, every slice's part added in rank
    order (``merge_partials``), the same numbers on every rank."""
    from repro_torch.kernels.flash_decode.ref import merge_partials
    m, me = model_size(), model_rank()
    heads = [hh for hh, _ in head_split(n_heads, n_kv, m)]
    both = torch.cat([o, lse[..., None]], -1)           # (B, 1, H, D + 1)
    h0, h1 = heads[me]
    got = _exchange([both[:, :, a:b] if t != me else both[:, :, :0]
                     for t, (a, b) in enumerate(heads)],
                    [(*both.shape[:2], 0 if r == me else h1 - h0,
                      both.shape[3]) for r in range(m)], _ctx().model.group)
    got[me] = both[:, :, h0:h1]
    parts = torch.stack(got)
    return merge_partials(parts[..., :-1], parts[..., -1])


def _conv_layout(d_inner: int, n_state: int):
    """(the channels of the convolution tail each rank computes: its x
    channels and all of B and C; the chunks the cache holds), as ranges of
    the tail's d_inner + 2N channels."""
    m = model_size()
    w = d_inner // m
    bc = (d_inner, d_inner + 2 * n_state)
    have = [[(r * w, (r + 1) * w), bc] for r in range(m)]
    chunks = [[c] if c[1] > c[0] else []
              for c in chunk_ranges(d_inner + 2 * n_state, m)]
    return have, chunks


def conv_to_cache(tail, d_inner: int, n_state: int):
    """A prompt's convolution tail (B, K-1, channels this rank computes)
    as the cache holds it: this rank's chunk of the channels."""
    if model_size() == 1:
        return tail
    have, chunks = _conv_layout(d_inner, n_state)
    return regroup(tail, 2, have, chunks)


def conv_from_cache(chunk, d_inner: int, n_state: int):
    """The cached convolution tail (this rank's chunk of the channels) for
    the channels this rank computes (its x channels, B and C)."""
    if model_size() == 1:
        return chunk
    have, chunks = _conv_layout(d_inner, n_state)
    return regroup(chunk, 2, chunks, have)


def conv_step(chunk, xbc, d_inner: int, n_state: int):
    """The cached tail after one decode step: ``chunk`` (B, K-1, this
    rank's chunk) shifted by one position and the step's new values
    ``xbc`` (B, 1, the channels this rank computes) of its chunk
    appended."""
    have, chunks = _conv_layout(d_inner, n_state)
    return torch.cat([chunk[:, 1:], regroup(xbc, 2, have, chunks)], 1)


def write_at(cache, new, at) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at position
    ``at`` (a 0-d tensor on the cache's device) in place where 0 <= at <
    S, and nowhere otherwise, with no copy to the host: the rank of a
    sequence-sharded cache that owns the position writes it. e4m3 caches
    are written as bytes (``index_copy_`` takes no e4m3 on either
    device)."""
    n = cache.shape[1]
    inside = (at >= 0) & (at < n)
    idx = at.clamp(0, n - 1).reshape(1).long()
    new = new.to(cache.dtype)
    if cache.element_size() == 1 and cache.dtype.is_floating_point:
        cache, new = cache.view(torch.uint8), new.view(torch.uint8)
    cache.index_copy_(1, idx, torch.where(inside, new,
                                          cache.index_select(1, idx)))
