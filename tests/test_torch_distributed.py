"""The port's distributed layer on the CPU over gloo process groups, held to
the reference where the reference runs: logical-axis rules and the
parameter, batch and cache specs (pure Python, every reduced config);
``shard`` without rules; the sharded (tensor-parallel) train step on a
(2, 2) mesh against the single-device step (what
``tests/test_distributed.py:23`` means; ``test_torch_tp.py`` holds more
configs and meshes);
elastic 8 -> 4 -> 8 (``:56``); ``compressed_psum`` over 8 ranks against
the reference's ``shard_map`` run (``:78``); GPipe on 4 ranks against the
layers in sequence (``:104``, what it means).

Each multi-process check starts one ``tests/torch_dist_worker.py`` process
per rank (``torch_dist_worker.run_ranks``), joined through a ``FileStore``
in the test's temporary directory (no port, so the xdist workers cannot
collide), with its own timeout.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sharding
from repro.models import build_model as j_build_model
from repro.models.model import init_cache as j_init_cache
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding
from repro_torch.models import build_model
from repro_torch.models.model import forward, init_cache
from torch_dist_worker import REPO
from torch_dist_worker import run_ranks as _run_ranks

torch.set_num_threads(1)
MESHES = {"2x2": ("data", "model"), "2x2x2": ("pod", "data", "model")}


def _same_specs(got, want, path=""):
    """Two spec trees equal leaf by leaf (the port's tuples against the
    reference's PartitionSpecs)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_specs(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, sharding.PartitionSpec), path
    assert tuple(got) == tuple(want), (path, got, want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return types.SimpleNamespace(shape=tuple(tree.shape))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_are_the_references_leaf_by_leaf(arch, mesh):
    names = MESHES[mesh]
    jmesh = types.SimpleNamespace(axis_names=names)
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jshapes = jax.eval_shape(
        lambda: j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = build_model(tcfg).init(0, device="cpu")
    for mode in ("train", "inference"):
        _same_specs(sharding.param_specs(tparams, names, mode=mode),
                    j_sharding.param_specs(jshapes, jmesh, mode=mode))
    # the specs as DTensor placements: Shard(d) on each mesh axis that dim
    # d names, Replicate() on the others
    specs = sharding.param_specs(tparams, names)
    placed = sharding.named_sharding(names, specs)
    for spec, place in zip(_leaves(specs), _leaves(placed)):
        want = []
        for ax in names:
            dims = [d for d, e in enumerate(spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)]
            want.append(Shard(dims[0]) if dims else Replicate())
        assert place == tuple(want), (spec, place)
    if jcfg.family == "vlm":
        batch = {"patch_embeds": np.zeros((2, jcfg.n_patches, jcfg.d_model)),
                 "tokens": np.zeros((2, 16), np.int32)}
    else:
        batch = {"tokens": np.zeros((2, 16), np.int32)}
    _same_specs(sharding.batch_specs(_shapes(batch), names),
                j_sharding.batch_specs(batch, jmesh))
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, 2, 64))
    tcache = init_cache(tcfg, 2, 64, device="cpu")
    _same_specs(sharding.cache_specs(tcache, names),
                j_sharding.cache_specs(jcache, jmesh))


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["model"])
def test_axis_rules_map_logical_axes_as_the_reference(mesh):
    names = MESHES.get(mesh, ("model",))
    jmesh = types.SimpleNamespace(axis_names=names)
    logical = [("batch", None, "heads", None), ("batch", "kv_seq", None),
               ("experts", "batch", "ff"), ("batch", "seq_sp", "embed"),
               ("batch", None, "vocab"), ("batch", None, "ssm_heads", None)]
    with sharding.axis_rules(names), j_sharding.axis_rules(jmesh):
        for lg in logical:
            assert tuple(sharding.logical_to_spec(lg)) == \
                tuple(j_sharding.logical_to_spec(lg)), lg
    with sharding.axis_rules(names, {"experts": "model"}), \
            j_sharding.axis_rules(jmesh, {"experts": "model"}):
        assert tuple(sharding.logical_to_spec(("experts",))) == \
            tuple(j_sharding.logical_to_spec(("experts",)))


def test_shard_without_rules_returns_its_argument():
    x = torch.randn(2, 8, 4)
    assert sharding.shard(x, ("batch", None, "heads")) is x
    with sharding.axis_rules(None):           # rules, no mesh
        assert sharding.shard(x, ("batch", None, "heads")) is x
    with sharding.axis_rules(("data", "model")):   # a plain tensor
        assert sharding.shard(x, ("batch", None, "heads")) is x
        assert sharding._current_rules()["batch"] == ("data",)
    assert sharding._current_rules() is None and \
        sharding._current_mesh() is None


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b"])
def test_annotated_models_give_the_same_numbers_under_rules(arch):
    """The models' shard annotations on local tensors (as the sharded step
    runs them, inside local_map) change no number."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    plain, _ = forward(params, {"tokens": tokens}, cfg)
    with sharding.axis_rules(("data", "model")):
        ruled, _ = forward(params, {"tokens": tokens}, cfg)
    assert torch.equal(plain, ruled)


@pytest.mark.parametrize("opt,transform", [("adafactor", False),
                                           ("adamw", True)])
def test_the_sharded_step_refuses_what_it_cannot_shard(opt, transform):
    """Each rank updates its own shards: Adafactor's row and column
    statistics, and a gradient transform over whole leaves, would need the
    other ranks' shards."""
    from repro_torch.train.compression import make_compressor
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    with pytest.raises(ValueError, match="sharded step"):
        make_train_step(get_config("granite-3-2b").reduced(),
                        make_optimizer(opt), mesh=("data", "model"),
                        grad_transform=make_compressor() if transform
                        else None)


def test_sharded_train_step_on_a_2x2_mesh_is_the_single_device_step(
        tmp_path):
    outs = _run_ranks("granite", 4, tmp_path)
    assert all("OK" in o for o in outs)


def test_elastic_rescale_8_4_8(tmp_path):
    outs = _run_ranks("elastic", 8, tmp_path)
    assert all("events [(8, 4), (4, 8)]" in o for o in outs)


REF_PSUM = """
import sys
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.train.compression import compressed_psum
mesh = jax.make_mesh((8,), ("data",))
g = jnp.asarray(np.linspace(-1, 1, 8 * 32, dtype=np.float32).reshape(8, 32))

@partial(shard_map, mesh=mesh, in_specs=P("data", None),
         out_specs=P("data", None))
def allreduce(x):
    return compressed_psum({"g": x}, "data", jax.random.PRNGKey(0))["g"]

np.save(sys.argv[1], np.asarray(allreduce(g)))
"""


def test_compressed_psum_over_8_ranks_is_the_references(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_out = tmp_path / "ref.npy"
    ref = subprocess.Popen([sys.executable, "-c", REF_PSUM, str(ref_out)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        _run_ranks("psum", 8, tmp_path)
        log = ref.communicate(timeout=90)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    want = np.load(ref_out)
    got = np.concatenate([np.load(tmp_path / f"psum_{r}.npy")
                          for r in range(8)])
    # every rank holds the group's sum; bitwise the reference's (the same
    # threefry draws, the same shared scale, an exact int32 sum)
    assert np.array_equal(got, want)
    g = np.linspace(-1, 1, 8 * 32, dtype=np.float32).reshape(8, 32)
    assert np.max(np.abs(got - g.sum(0, keepdims=True))) < 0.15


def test_gpipe_on_4_ranks_equals_the_layers_in_sequence(tmp_path):
    outs = _run_ranks("gpipe", 4, tmp_path)
    assert all("largest difference" in o for o in outs)
