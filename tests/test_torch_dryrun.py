"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

The reference's own contract (``tests/test_distributed.py:130-148``),
which its XLA dry run fails, through the port's CLI on fake (2, 2) and
(2, 2, 2) meshes with ``--device cpu``; ``benchmarks/roofline.py``
renders the rows. At the reduced granite-3-2b on a fake (2, 2) mesh: the
traced train step's FLOPs and peak memory per rank are exactly those of
the same step run for real on a (2, 2) gloo mesh (``FlopCounterMode`` and
``dryrun.LiveMode`` in each rank, ``torch_dist_worker.dry_real``); the
traced prefill and decode FLOPs are the count over the unsharded step on
real CPU tensors at the per-rank batch, and every step's on a one-rank
mesh at the whole batch; the collective bytes are what ``param_specs``
and the shapes imply. On a real one-rank gloo mesh the sharded prefill
and decode are bitwise the unsharded steps. With ``cfg.seq_shard``
(``--seq-shard``) the same holds of the train step's FLOPs and peak
against a real (2, 2) run with the flag, the peak is below the step's
without it, and each activation all-reduce over "model" becomes a gather
and a reduce-scatter of the sequence (each one all-to-all).
"""
import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import param_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.utils.misc import tree_flatten_with_path  # noqa: E402
from torch_dist_worker import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# DTensor warns at every two-axis redistribution; the tests read numbers
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
CFG = get_config("granite-3-2b").reduced()
SHAPES = {kind: ShapeConfig(kind, 64, 4, kind)
          for kind in ("train", "prefill", "decode")}


def test_reference_contract_through_the_cli(tmp_path):
    out = tmp_path / "dry.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--test-mesh", "--arch", "granite-3-2b", "--shape",
         "train_4k,decode_32k", "--mesh", "both", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 4
    for row in rows:
        assert row["status"] == "ok", row
        assert row["cost"]["flops"] > 0
        assert row["roofline"]["bottleneck"] in ("compute", "memory",
                                                 "collective")
        assert row["memory"]["peak_gb"] >= row["memory"]["argument_gb"] > 0
    assert {r["chips"] for r in rows} == {4, 8}
    sys.path.insert(0, REPO)
    try:
        from benchmarks.roofline import load_rows, markdown_table
    finally:
        sys.path.remove(REPO)
    table = markdown_table(load_rows(str(out)))
    assert table.count("| granite-3-2b |") == 4


def _real_flops(kind, batch):
    """FlopCounterMode over the unsharded step on real CPU tensors."""
    params = build_model(CFG).init(0, device="cpu")
    seq = SHAPES[kind].seq_len
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab, (batch, seq)).astype(np.int32))
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = make_optimizer("adamw")
            make_train_step(CFG, opt)(params, opt.init(params),
                                      {"tokens": tokens})
        elif kind == "prefill":
            prefill(params, {"tokens": tokens}, CFG)
        else:
            decode_step(params, init_cache(CFG, batch, seq, "cpu"),
                        tokens[:, :1], CFG)
    return fc.get_total_flops()


SEQ_CFG = dataclasses.replace(CFG, seq_shard=True)


def _trace(kind, world, shape=(2, 2), cfg=CFG):
    with dryrun.fake_world(world):
        mesh = make_test_mesh(*shape, device_type="cpu")
        return dryrun.trace_cell(cfg, SHAPES[kind], mesh, device="cpu")


def _real(tmp_path_factory, check):
    """The (2, 2) cells run for real on 4 gloo ranks (``check`` of
    ``torch_dist_worker``): each rank's FLOPs, peak and argument GiB."""
    tmp = tmp_path_factory.mktemp(check.replace(":", "_"))
    run_ranks(check, 4, tmp, timeout=240)
    return [json.load(open(tmp / f"dry_{r}.json")) for r in range(4)]


@pytest.fixture(scope="module")
def real_train(tmp_path_factory):
    return _real(tmp_path_factory, "dry_real")


@pytest.fixture(scope="module")
def real_train_seq(tmp_path_factory):
    return _real(tmp_path_factory, "dry_real:seq")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_flops_are_the_real_count_per_rank(kind, real_train):
    """Each step, tensor-parallel over "model" with the batch halved over
    "data", traced on fake tensors counts what the same step counts run
    for real on four gloo ranks, and less than one device's step on the
    rank's half of the batch."""
    got = _trace(kind, 4)
    assert got["kind"] == kind
    key = "flops" if kind == "train" else f"flops_{kind}"
    assert all(got["flops"] == r[key] for r in real_train), real_train
    assert got["flops"] < _real_flops(kind, SHAPES[kind].global_batch // 2)


def test_traced_peak_of_the_train_cell_is_the_real_runs_per_rank(
        real_train):
    """The fake trace's books of live storages (``TraceMode``) against the
    same books kept over the real step on each rank (``LiveMode``): the
    arguments and the peak, each layer's gathered weights freed after the
    layer and gathered again in the backward."""
    mem = _trace("train", 4)["memory"]
    for r in real_train:
        assert mem["argument_gb"] == r["argument_gb"], (mem, r)
        assert mem["peak_gb"] == r["peak_gb"], (mem, r)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_seq_shard_traced_flops_are_the_real_count_per_rank(kind,
                                                            real_train_seq):
    """The same steps with ``cfg.seq_shard``: each traced count is the real
    run's, and the same as without the flag (the blocks compute on the
    gathered sequence, the norms on the slice count no FLOPs)."""
    got = _trace(kind, 4, cfg=SEQ_CFG)
    key = "flops" if kind == "train" else f"flops_{kind}"
    assert all(got["flops"] == r[key] for r in real_train_seq), \
        real_train_seq
    assert got["flops"] == _trace(kind, 4)["flops"]


def test_seq_shard_traced_peak_of_the_train_cell_is_the_real_runs_per_rank(
        real_train_seq):
    """The train step with ``cfg.seq_shard``: the traced arguments and
    peak are the real run's books per rank, and the peak is below the
    step's without it (each layer saves the rank's slice of its input)."""
    mem = _trace("train", 4, cfg=SEQ_CFG)["memory"]
    for r in real_train_seq:
        assert mem["argument_gb"] == r["argument_gb"], (mem, r)
        assert mem["peak_gb"] == r["peak_gb"], (mem, r)
    assert mem["peak_gb"] < _trace("train", 4)["memory"]["peak_gb"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_mesh_traces_the_unsharded_flops(kind):
    got = _trace(kind, 1, (1, 1))
    assert got["flops"] == _real_flops(kind, SHAPES[kind].global_batch)
    assert sum(got["collectives"]["bytes_by_kind"].values()) == 0


def test_collective_bytes_are_what_param_specs_imply():
    """The train step on (2, 2), 4 x 64 tokens (2 a rank), fp32, derived
    from ``param_specs`` and the shapes:

      * all-gather: each layer's leaf with an FSDP dim, gathered over
        "data" to its "model" shard (nbytes / 2 of the stacked leaf over
        its layers) in the forward and again in the backward's recompute;
        one gather a layer and leaf, never a whole weight;
      * reduce-scatter: each such leaf's gradient onto its (2, 2) shard
        (nbytes / 4), once;
      * all-reduce over "data": the gradient of each leaf with no FSDP dim,
        its local shard's bytes (``embed`` and ``lm_head`` over "model",
        the norms whole);
      * all-reduce over "model", activations (2, 64, d): the embedding's
        sum; in each block 2 in the forward (after ``wo`` and ``w_down``),
        1 in the recompute (after ``wo``: the recompute stops at the last
        tensor the backward needs, before the block's last sum) and 2 in
        the backward (the gradients of the attention's and the MLP's
        inputs); the gradient of the logits' input; and the
        cross-entropy's max, sum and label logit, (2, 64) fp32;
      * the loss's sum over "data" and the clip's norm: a few scalars.
    """
    got = _trace("train", 4)["collectives"]
    params = build_model(CFG).init(0, device="cpu")
    paths, leaves = tree_flatten_with_path(params)
    _, specs = tree_flatten_with_path(param_specs(params, ("data",
                                                           "model")))
    gather = scatter = data_sums = n_gathered = 0
    for t, spec in zip(leaves, specs):
        nbytes = t.numel() * t.element_size()
        axes = [a for e in spec for a in ((e,) if isinstance(e, str)
                                          else e or ())]
        local = nbytes // 2 ** len(axes)
        if "data" in axes:
            gather += 2 * nbytes // (2 if "model" in axes else 1)
            scatter += local
            n_gathered += 2 * t.shape[0]
        else:
            data_sums += local
    b, s = SHAPES["train"].global_batch // 2, SHAPES["train"].seq_len
    act = b * s * CFG.d_model * 4
    model_sums = act * (1 + 5 * CFG.n_layers + 1) + 3 * b * s * 4
    by_kind = got["bytes_by_kind"]
    assert by_kind["all-gather"] == gather > 0
    assert got["counts"]["all-gather"] == n_gathered
    assert by_kind["reduce-scatter"] == scatter > 0
    want = data_sums + model_sums
    assert want <= by_kind["all-reduce"] <= want + 64, (by_kind, want)
    assert by_kind["all-to-all"] == 0     # (2, 2): heads and KV heads align


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_reduced_config_traces_with_seq_shard(arch):
    """Each family's reduced config (the VLM's patches prepended before the
    sequence is cut, MoE, Mamba2, the hybrid, qwen1.5-32b's uneven heads)
    traced on a fake (1, 4) mesh with ``cfg.seq_shard``: the same FLOPs as
    without it, and no higher a peak."""
    cfg = get_config(arch).reduced()
    seq = dataclasses.replace(cfg, seq_shard=True)
    got = [_trace("train", 4, (1, 4), c) for c in (cfg, seq)]
    assert got[1]["flops"] == got[0]["flops"]
    assert got[1]["memory"]["peak_gb"] <= got[0]["memory"]["peak_gb"]
    assert got[1]["collectives"]["bytes_by_kind"]["all-to-all"] > 0


def test_seq_shard_collective_bytes_are_what_the_shapes_imply():
    """The train and prefill cells of ``test_collective_bytes_are_what_
    param_specs_imply`` and ``_serve_bytes`` with ``cfg.seq_shard``,
    activations act = (2, 64, d) fp32 a rank, L layers:

      * the FSDP all-gathers and reduce-scatters of the weights as without
        the flag;
      * every activation all-reduce over "model" gone: in their place,
        all-to-alls (the sequence pair: a gather's result the gathered
        act, a reduce-scatter's the m pieces received, act too). Train:
        the embedding's reduce-scatter and its gather in the backward; in
        each block a gather and a reduce-scatter at the attention's and
        the MLP's entry and exit (4), their recompute up to the MLP's
        gather (3) and each one's adjoint in the backward (4); the head's
        gather and its reduce-scatter in the backward: act x (11 L + 4).
        Prefill: the embedding's and each block's 4, and the last
        position of each slice gathered for the logits ((2, 2, d)), beside
        the K/V and vocab all-to-alls of ``_serve_bytes``;
      * all-reduce over "model" (train): the norms' scale gradients (each
        rank's tokens add to them: ln1 and ln2 a layer, ln_f, d fp32 each)
        and the cross-entropy's three (2, 64) fp32; over "data" the
        gradients of the leaves with no FSDP dim, and a few scalars."""
    train = _trace("train", 4, cfg=SEQ_CFG)["collectives"]
    base = _trace("train", 4)["collectives"]
    b, s, d, n = 2, SHAPES["train"].seq_len, CFG.d_model, CFG.n_layers
    act = b * s * d * 4
    got, was = train["bytes_by_kind"], base["bytes_by_kind"]
    for kind in ("all-gather", "reduce-scatter"):
        assert got[kind] == was[kind] > 0
        assert train["counts"][kind] == base["counts"][kind]
    assert was["all-to-all"] == 0
    assert got["all-to-all"] == act * (11 * n + 4)
    assert train["counts"]["all-to-all"] == 11 * n + 4
    model_sums = act * (1 + 5 * n + 1)      # the flag's all-reduces gone
    assert got["all-reduce"] == was["all-reduce"] - model_sums \
        + (2 * n + 1) * d * 4
    prefill = _trace("prefill", 4, cfg=SEQ_CFG)["collectives"]
    want, _ = _serve_bytes("prefill", False)
    want["all-to-all"] += act * (1 + 4 * n) + b * 2 * d * 4
    want["all-reduce"] = 0
    assert prefill["bytes_by_kind"] == want, (prefill, want)


def test_sharded_serve_is_bitwise_on_one_rank(tmp_path):
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, worker, "serve_one_rank", "0", "1",
                        str(tmp_path / "store"), str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.count("bitwise") == 2


def _serve_bytes(kind, infer_tp):
    """The (2, 2) serve cell's collective bytes at rank 0 (the fake
    world's), derived from the specs and the shapes: batch 4 over "data"
    (2 a rank), 64 tokens or a 64-position cache over "model" (32 a
    rank), fp32, ``head_split``'s heads (rank 0: query heads 0-1, KV head
    0; rank 1: 2-3 and 1):

      * all-gather: ZeRO-3 only, each layer's leaf with an FSDP dim
        gathered over "data" to its "model" shard, once (no backward);
      * all-reduce over "model", the activations: the embedding's sum, and
        in each block the sums after ``wo`` and ``w_down``;
      * all-to-all over "model", only what comes from the other rank:
        prefill, each layer's K and V of the other rank's KV head for this
        rank's 32 positions (``tp.kv_to_cache``); decode, each layer's
        q of the other rank's query heads and K/V of its KV head
        (``tp.gather_heads``), then the other rank's output and
        log-sum-exp over its slice for this rank's heads (``tp.
        merge_heads``); both, the other half of the last position's
        logits (``tp.gather_vocab``)."""
    from repro_torch.distributed import tp
    params = build_model(CFG).init(0, device="cpu")
    _, leaves = tree_flatten_with_path(params)
    _, specs = tree_flatten_with_path(param_specs(params, ("data",
                                                           "model")))
    gather = n_gathered = 0
    for t, spec in zip(leaves, specs):
        axes = [a for e in spec for a in ((e,) if isinstance(e, str)
                                          else e or ())]
        if "data" in axes and not infer_tp:
            gather += t.numel() * 4 // (2 if "model" in axes else 1)
            n_gathered += t.shape[0]
    b, s, d, hd = 2, SHAPES[kind].seq_len, CFG.d_model, CFG.head_dim
    n_layers, v = CFG.n_layers, CFG.padded_vocab
    (h0, h1), (k0, k1) = tp.head_split(CFG.n_heads, CFG.n_kv, 2)[0]
    other_kv = CFG.n_kv - (k1 - k0)
    act = b * (s if kind == "prefill" else 1) * d * 4
    if kind == "prefill":
        a2a = n_layers * 2 * b * (s // 2) * other_kv * hd * 4
    else:
        a2a = n_layers * 4 * b * (
            (CFG.n_heads - (h1 - h0)) * hd + 2 * other_kv * hd
            + (h1 - h0) * (hd + 1))
    return {"all-gather": gather, "all-reduce": act * (1 + 2 * n_layers),
            "all-to-all": a2a + b * (v // 2) * 4, "reduce-scatter": 0,
            "collective-permute": 0}, n_gathered


@pytest.mark.parametrize("infer_tp", [False, True])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_cells_shard_the_cache_and_move_what_the_specs_imply(
        kind, infer_tp):
    """A (2, 2) prefill and decode cell traced on fake tensors, with the
    weights ZeRO-3 and under ``--infer-tp`` ("model" only): each cache
    leaf the step returns is the shard ``cache_specs`` gives this rank
    (K/V sequence, over "model", batch over "data"), and its collective
    bytes by kind are ``_serve_bytes``'."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import axis_rules, placements
    from repro_torch.launch.inputs import input_specs
    want, n_gathered = _serve_bytes(kind, infer_tp)
    with dryrun.fake_world(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        got = dryrun.trace_cell(CFG, SHAPES[kind], mesh, device="cpu",
                                infer_tp=infer_tp)["collectives"]
        _, spec = input_specs(CFG, SHAPES[kind], device="cpu")
        p_shapes = dryrun.params_shape(CFG)
        mode = dryrun.TraceMode()
        with axis_rules(mesh):
            params = dryrun.distribute_like(
                p_shapes, mesh, param_specs(
                    p_shapes, mesh,
                    mode="inference" if infer_tp else "train"), mode, "cpu")
            specs = dryrun.serve_specs(CFG, kind, mesh, spec)
            inputs = dryrun.distribute_like(spec, mesh, specs["inputs"],
                                            mode, "cpu")
            with mode:
                _, cache = dryrun.serve_step(CFG, kind, mesh, params, inputs)
            paths, leaves = tree_flatten_with_path(cache)
            _, c_specs = tree_flatten_with_path(specs["cache"])
            shards = {}
            for p, t, sp in zip(paths, leaves, c_specs):
                local, _ = compute_local_shape_and_global_offset(
                    t.shape, mesh, placements(sp, mesh, t.dim()))
                shards[p] = (tuple(t.to_local().shape), tuple(local))
    assert shards["['k']"][1] == (CFG.n_layers, 2, 32, CFG.n_kv,
                              CFG.head_dim), shards
    assert all(a == b for a, b in shards.values()), shards
    assert got["bytes_by_kind"] == want, (got, want)
    assert got["counts"]["all-gather"] == n_gathered
