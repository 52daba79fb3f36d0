"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

The reference's own contract (``tests/test_distributed.py:130-148``),
which its XLA dry run fails, through the port's CLI on fake (2, 2) and
(2, 2, 2) meshes with ``--device cpu``; ``benchmarks/roofline.py``
renders the rows. At the reduced granite-3-2b on a fake (2, 2) mesh: the
traced FLOPs per rank are exactly the count of ``FlopCounterMode`` over
the unsharded step on real CPU tensors at the per-rank batch, and on a
one-rank mesh at the whole batch; the all-gather and reduce-scatter
bytes are what ``param_specs`` implies. On a real one-rank gloo mesh the
sharded prefill and decode are bitwise the unsharded steps.
"""
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import param_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.utils.misc import tree_flatten_with_path  # noqa: E402

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


def _trace(kind, world, shape=(2, 2)):
    with dryrun.fake_world(world):
        mesh = make_test_mesh(*shape, device_type="cpu")
        return dryrun.trace_cell(CFG, SHAPES[kind], mesh, device="cpu")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_flops_are_the_real_count_per_rank(kind):
    got = _trace(kind, 4)
    assert got["kind"] == kind
    # the (2, 2) mesh's FSDP axis is "data": each rank takes half the batch
    assert got["flops"] == _real_flops(kind, SHAPES[kind].global_batch // 2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_mesh_traces_the_unsharded_flops(kind):
    got = _trace(kind, 1, (1, 1))
    assert got["flops"] == _real_flops(kind, SHAPES[kind].global_batch)
    assert sum(got["collectives"]["bytes_by_kind"].values()) == 0


def test_collective_bytes_are_what_param_specs_imply():
    """On (2, 2) each weight is gathered whole once a step (an axis of 2
    the spec shards: the first gather returns half the weight, the second
    the whole), and each gradient sharded over "data" is reduce-scattered
    to half."""
    got = _trace("train", 4)["collectives"]["bytes_by_kind"]
    params = build_model(CFG).init(0, device="cpu")
    paths, leaves = tree_flatten_with_path(params)
    _, specs = tree_flatten_with_path(param_specs(params, ("data",
                                                           "model")))
    gather = scatter = 0
    for t, spec in zip(leaves, specs):
        nbytes = t.numel() * t.element_size()
        axes = [a for e in spec for a in ((e,) if isinstance(e, str)
                                          else e or ())]
        gather += {0: 0, 1: nbytes, 2: nbytes + nbytes // 2}[len(axes)]
        scatter += nbytes // 2 if "data" in axes else 0
    assert got["all-gather"] == gather > 0
    assert got["reduce-scatter"] == scatter > 0
    serve = _trace("prefill", 4)["collectives"]["bytes_by_kind"]
    assert serve["all-gather"] == gather and serve["reduce-scatter"] == 0


def test_sharded_serve_is_bitwise_on_one_rank(tmp_path):
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, worker, "serve_one_rank", "0", "1",
                        str(tmp_path / "store"), str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.count("bitwise") == 2
