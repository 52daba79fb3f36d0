"""Logical-axis sharding (MaxText-style) for the LM substrate, over DTensor
placements on a ``DeviceMesh``.

The reference's ``repro/distributed/sharding.py`` on torch. Model code
annotates activations with *logical* axis names via ``shard(x, ("batch",
"seq", "embed"))``. A rules table (thread-local, set by the launcher with
``axis_rules``) maps logical names to mesh axes; with no rules active the
annotations return their argument itself, so the same model code runs in
single-device tests and on a mesh. Under rules, ``shard`` redistributes a
DTensor to the annotation's placements (the counterpart of JAX's
``with_sharding_constraint``) and leaves a plain tensor as it is: a local
shard inside ``local_map`` has no layout to constrain.

Weight sharding is derived from parameter *path names* by ``param_specs``:

  * TP-natural output dims (heads, d_ff, vocab) shard over "model";
  * the other large dim shards over the FSDP axes ("pod", "data"), ZeRO-3:
    parameters, gradients and Adam moments are all fully distributed;
  * biases and norms replicate.

Specs are ``PartitionSpec`` tuples, one entry per tensor dim (None, a
mesh axis or a tuple of mesh axes), equal entry for entry to the
reference's ``jax.sharding.PartitionSpec``; ``placements`` turns one into
DTensor placements on a mesh (a dim over several mesh axes is sharded by
each of them in mesh order, as JAX does). Every function that only reads
axis names takes a ``DeviceMesh`` or the sequence of its axis names.
"""
from __future__ import annotations

import contextlib
import threading

# mesh axes used by the production meshes (launch/mesh.py)
FSDP_AXES = ("pod", "data")  # "pod" may be absent on single-pod meshes
MODEL_AXIS = "model"

# logical activation axis -> mesh axes (None = replicated)
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": FSDP_AXES,       # data parallel over pod x data
    "seq": None,              # sequence kept whole by default
    "seq_sp": MODEL_AXIS,     # sequence-parallel regions (norms/residuals)
    "embed": None,
    "heads": MODEL_AXIS,      # attention heads / per-head dims after proj
    "kv_seq": MODEL_AXIS,     # decode KV cache: sequence-sharded
    "ff": MODEL_AXIS,         # MLP hidden
    "vocab": MODEL_AXIS,      # logits vocab dim
    "experts": None,          # MoE experts (TP mode; EP mode remaps this)
    "ssm_heads": MODEL_AXIS,  # Mamba2 state heads
    "state": None,
}

_local = threading.local()


def _canonical(part):
    """An entry as JAX's PartitionSpec keeps it: a sequence of one axis as
    that axis, an empty one as None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the dim split over each, in order)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh``, or of a sequence of names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh)


def _current_rules() -> dict | None:
    return getattr(_local, "rules", None)


def _current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Activate sharding rules (launcher only; tests run without)."""
    base = dict(DEFAULT_RULES)
    if rules:
        base.update(rules)
    if mesh is not None:
        # drop rules referencing axes the mesh does not have
        names = set(axis_names(mesh))

        def keep(v):
            if v is None:
                return None
            if isinstance(v, str):
                return v if v in names else None
            return tuple(a for a in v if a in names) or None

        base = {k: keep(v) for k, v in base.items()}
    prev_rules, prev_mesh = _current_rules(), _current_mesh()
    _local.rules, _local.mesh = base, mesh
    try:
        yield
    finally:
        _local.rules, _local.mesh = prev_rules, prev_mesh


def logical_to_spec(logical: tuple[str | None, ...]) -> PartitionSpec:
    rules = _current_rules() or {}
    return P(*(rules.get(name) if name else None for name in logical))


def placements(spec, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements on ``mesh`` of a spec: ``Shard(d)`` on each mesh
    axis that the spec names for tensor dim ``d``, ``Replicate()`` on the
    others. ``ndim`` pads a shorter spec with replicated dims."""
    from torch.distributed.tensor import Replicate, Shard
    entries = tuple(spec) + (None,) * ((ndim or len(spec)) - len(spec))
    where = {}
    for d, entry in enumerate(entries):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            where[ax] = d
    return tuple(Shard(where[ax]) if ax in where else Replicate()
                 for ax in axis_names(mesh))


def shard(x, logical: tuple[str | None, ...]):
    """``x`` laid out by logical axis names: without rules or a mesh, ``x``
    itself; under rules, a DTensor redistributed to the placements of
    ``logical_to_spec(logical)``, a plain tensor as it is."""
    mesh = _current_mesh()
    if mesh is None or _current_rules() is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(logical_to_spec(logical), mesh, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# --------------------------------------------------------------------------
# weight sharding by parameter path
# --------------------------------------------------------------------------

def _spec_for_path(path: str, ndim: int, fsdp, model) -> PartitionSpec:
    """Sharding spec from the parameter's path name.

    Stacked per-layer params have a leading L dim (never sharded): specs are
    right-aligned to the trailing dims.
    """
    def pad(*trailing):
        return P(*([None] * (ndim - len(trailing)) + list(trailing)))

    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("wq", "wk", "wv", "w_in", "w_gate", "w_up"):
        return pad(fsdp, model)          # (d_model, out) : out is TP-natural
    if leaf in ("wo", "w_out", "w_down"):
        return pad(model, fsdp)          # (in, d_model) : in is TP-natural
    if leaf == "embed":
        return pad(model, None)          # (V, d): vocab-parallel (Megatron)
    if leaf == "lm_head":
        return pad(None, model)          # (d, V): logits vocab-sharded
    if leaf == "in_proj":                # mamba2: (d_model, zxbcdt)
        return pad(fsdp, model)
    if leaf == "out_proj":               # mamba2: (d_inner, d_model)
        return pad(model, fsdp)
    if leaf in ("conv_w",):              # (K, channels)
        return pad(None, model)
    if leaf in ("a_log", "ssm_d", "dt_bias"):
        return pad(model)                # per-ssm-head vectors
    if leaf in ("we_gate", "we_up"):     # MoE expert weights (E, d, ff)
        return pad(None, fsdp, model)
    if leaf == "we_out":                 # (E, ff, d)
        return pad(None, model, fsdp)
    if leaf == "w_router":               # (d, E), tiny: replicate
        return pad(None, None)
    # biases, norm scales, small vectors: replicated
    return P(*([None] * ndim))


def _axes(mesh):
    names = set(axis_names(mesh))
    fsdp = tuple(a for a in FSDP_AXES if a in names) or None
    return fsdp, (MODEL_AXIS if MODEL_AXIS in names else None)


def param_specs(params_or_shapes, mesh, *, mode: str = "train") -> dict:
    """PartitionSpec tree for a parameter tree (by path rules).

    mode="train": ZeRO-3, weights shard over ("pod", "data") AND "model".
    mode="inference": TP only, weights shard over "model" and replicate
    across the data axes (ZeRO-3 at inference would all-gather every
    weight on every decoded token)."""
    fsdp, model = _axes(mesh)
    if mode == "inference":
        fsdp = None
    if fsdp is not None and len(fsdp) == 1:
        fsdp = fsdp[0]

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return _spec_for_path(prefix, len(tree.shape), fsdp, model)

    return walk(params_or_shapes)


def batch_specs(batch_shapes, mesh) -> dict:
    """Input batch: shard the leading (global batch) dim over FSDP axes."""
    fsdp, _ = _axes(mesh)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return P(fsdp, *([None] * (len(tree.shape) - 1)))

    return walk(batch_shapes)


def cache_specs(cache_shapes, mesh) -> dict:
    """Decode-cache sharding: KV sequence-sharded over "model" (flash-decode
    split-K pattern: kv_heads of 4/8 can never shard a 16-way axis), batch
    over the FSDP axes, SSM state heads over "model"."""
    fsdp, model = _axes(mesh)

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        leaf = prefix.rsplit("/", 1)[-1]
        if leaf in ("k", "v"):      # (L, B, S, n_kv, D)
            return P(None, fsdp, model, None, None)
        if leaf == "state":         # (L, B, H, P, N)
            return P(None, fsdp, model, None, None)
        if leaf == "conv":          # (L, B, K-1, C)
            return P(None, fsdp, None, model)
        return P()                  # pos scalar

    return walk(cache_shapes)


def named_sharding(mesh, spec_tree):
    """The tree of specs as DTensor placements on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named_sharding(mesh, v) for k, v in spec_tree.items()}
    return placements(spec_tree, mesh)


def distribute(tree, mesh, spec_tree):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements (every rank passes the same full tensors)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, spec_tree[k]) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(spec_tree, mesh,
                                                    tree.ndim))


def local_tree(tree):
    """Each DTensor of ``tree`` as its local shard (a view: an in-place
    update of it updates the DTensor); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local() if hasattr(tree, "to_local") else tree
