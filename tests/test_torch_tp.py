"""The sharded train step's tensor parallelism (``distributed.tp``) on the
CPU over gloo process groups, against one device.

Each piece of ``distributed/tp.py`` alone on 4 "model" ranks at a small
size (the vocab-parallel embedding and cross-entropy, the column- and
row-parallel MLP, GQA with fewer KV heads than ranks, a head count that
does not divide the ranks), and the whole train step of the reduced
granite-3-2b, phi3.5-moe, mamba2-780m and zamba2-7b on a (2, 2) and a
(1, 4) ("data", "model") mesh (``reduced()`` gives 2 KV heads, so (1, 4)
splits a KV head over two ranks) against the single-device step: the
loss, the gradient norm and every gradient within 1e-6 of the largest,
the parameters after AdamW within 0.05 lr (or twice the JAX reference's
own spread under 1-ulp moves of the weights where that is larger,
``tools/port_tp_spread.py``), and each rank's FLOPs at most 1 / model of
the one-device count plus the products every rank computes
(``torch_dist_worker.tp_unit``, ``tp_step``). One
``tests/torch_dist_worker.py`` process a rank, 4 ranks a test, ~10 s.

With ``cfg.seq_shard`` (sequence parallelism: the residual stream between
the blocks each "model" rank's slice of the sequence, gathered where a
block enters its tensor-parallel region and reduce-scattered where it
leaves it) the same steps are held to the same one-device step at the same
limits, a (1, 1) mesh is bitwise the unsharded step, the pair itself is
held to one device on 4 ranks (``tp_unit:seq``), the live peak of each
rank's step on (1, 4) is below the step's without it
(``torch_dist_worker.tp_seq_peak``), and a sequence that does not split
over "model" is refused.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import tp
from torch_dist_worker import TP_ARCHS, TP_MESHES, run_ranks

torch.set_num_threads(1)
TIMEOUT = 240


@pytest.mark.parametrize("piece", ["vocab", "mlp", "gqa", "uneven", "seq"])
def test_tp_piece_on_4_ranks_is_one_device(piece, tmp_path):
    outs = run_ranks(f"tp_unit:{piece}", 4, tmp_path, TIMEOUT)
    assert all(f"OK {piece}" in o for o in outs)


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("arch", sorted(TP_ARCHS))
def test_tp_train_step_is_the_single_device_step(arch, mesh, tmp_path):
    outs = run_ranks(f"tp_step:{arch}/{mesh}", 4, tmp_path, TIMEOUT)
    assert all(" of one device)" in o for o in outs)


def test_one_rank_mesh_step_is_bitwise_the_unsharded_step(tmp_path):
    outs = run_ranks("tp_one_rank", 1, tmp_path, TIMEOUT)
    assert outs[0].count("bitwise on a one-rank mesh") == len(TP_ARCHS)


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("arch", sorted(TP_ARCHS))
def test_seq_shard_train_step_is_the_single_device_step(arch, mesh,
                                                         tmp_path):
    outs = run_ranks(f"tp_step:{arch}/{mesh}/seq", 4, tmp_path, TIMEOUT)
    assert all(" of one device)" in o for o in outs)


def test_one_rank_mesh_seq_shard_step_is_bitwise_the_unsharded_step(
        tmp_path):
    outs = run_ranks("tp_one_rank:seq", 1, tmp_path, TIMEOUT)
    assert outs[0].count("bitwise on a one-rank mesh") == len(TP_ARCHS)


def test_seq_shard_lowers_the_live_peak_on_1x4(tmp_path):
    outs = run_ranks("tp_seq_peak", 4, tmp_path, TIMEOUT)
    assert all("OK rank" in o for o in outs)


def test_a_sequence_that_does_not_split_over_model_is_refused():
    """30 positions over 4 "model" ranks, under ``seq_shard``: refused
    before any collective, naming the flag, the sequence and the size."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              seq_shard=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.zeros((2, 30), dtype=torch.int32)
    with dryrun.fake_world(4):
        mesh = make_test_mesh(1, 4, device_type="cpu")
        with tp.sharded(mesh), pytest.raises(
                ValueError, match="seq_shard: a sequence of 30 positions "
                                  "does not split over 4 'model' ranks"):
            model.loss(params, {"tokens": tokens})
    tp.check_seq(30)                       # no "model" ranks: no split


def test_without_a_sharded_context_every_function_is_the_identity():
    x = torch.randn(2, 4, 8)
    tree = {"wq": torch.randn(8, 8), "ln1": torch.ones(8)}
    assert tp.copy_to_tp(x) is x and tp.reduce_from_tp(x) is x
    assert tp.copy_to_tp(x, seq=True) is x
    assert tp.reduce_from_tp(x, seq=True) is x and tp.use_once(x) is x
    assert tp.gather_layer(tree) is tree and tp.batch_mean(x) is x
    assert tp.model_size() == 1 and not tp.gathers()
    assert tp.attention_shard(tree, 4, 2, 2) is tree
    assert tp.ssm_shard(tree, 8, 2, 4) == (tree, 4)
    table = torch.randn(16, 8)
    tokens = torch.tensor([[0, 3, 15]])
    assert torch.equal(tp.embed_lookup(table, tokens), table[tokens])
    scale = torch.rand(8)
    from repro_torch.models.layers import rmsnorm
    assert torch.equal(tp.rmsnorm(x, scale), rmsnorm(x, scale))


def test_the_context_is_carried_into_another_thread():
    """A layer's recompute runs in the backward, on the autograd engine's
    thread for CUDA tensors: ``carried`` takes the sharded context there
    (the dry run's CUDA trace on 256 fake ranks failed without it)."""
    import threading

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    seen = {}
    with dryrun.fake_world(8):
        mesh = make_test_mesh(2, 4, device_type="cpu")
        with tp.sharded(mesh):
            both = tp.carried(lambda: (tp.model_size(), tp.gathers()))
            plain = lambda: (tp.model_size(), tp.gathers())  # noqa: E731
        for name, fn in (("carried", both), ("plain", plain)):
            t = threading.Thread(target=lambda n=name, f=fn:
                                 seen.__setitem__(n, f()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert seen == {"carried": (4, True), "plain": (1, False)}
    assert tp.carried(plain) is plain


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).n_heads])
def test_head_split_of_every_config_on_16_model_ranks(arch):
    """The split ``distributed/tp.py``'s docstring names for each config
    on the production meshes' 16 "model" ranks: query heads a rank, KV
    heads a rank, local G (qwen1.5-32b 2 or 3 whole heads; 8 KV heads
    against 32: one KV head, G 2; yi-9b's 4 against 32: G 2; 8 against
    48: 3 query heads on one KV head)."""
    cfg = get_config(arch)
    split = {(h1 - h0, k1 - k0, (h1 - h0) // (k1 - k0))
             for (h0, h1), (k0, k1) in tp.head_split(cfg.n_heads, cfg.n_kv,
                                                      16)}
    want = {"qwen1.5-32b": {(2, 2, 1), (3, 3, 1)},
            "granite-3-2b": {(2, 1, 2)}, "minitron-8b": {(2, 1, 2)},
            "phi3.5-moe-42b-a6.6b": {(2, 1, 2)}, "yi-9b": {(2, 1, 2)},
            "internvl2-26b": {(3, 1, 3)}, "grok-1-314b": {(3, 1, 3)},
            "zamba2-7b": {(2, 2, 1)}, "musicgen-large": {(2, 2, 1)}}[arch]
    assert split == want, split


def test_query_heads_grouped_unevenly_over_kv_heads_are_refused():
    """10 query heads on 5 KV heads over 4 ranks would put 3 query heads
    on 2 KV heads on rank 1; 10 on 10 splits 2 or 3 whole heads a rank."""
    with pytest.raises(ValueError, match="group unevenly"):
        tp.head_split(10, 5, 4)
    assert [h1 - h0 for (h0, h1), _ in tp.head_split(10, 10, 4)] == \
        [2, 3, 2, 3]


@pytest.mark.parametrize("arch,per_rank", [("mamba2-780m", 3),
                                           ("zamba2-7b", 7)])
def test_mamba2_heads_split_whole_on_16_model_ranks(arch, per_rank):
    cfg = get_config(arch)
    assert cfg.ssm_heads == 16 * per_rank
