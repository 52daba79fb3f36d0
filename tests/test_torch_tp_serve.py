"""Tensor-parallel prefill and decode (``launch.dryrun.serve_step`` under
``distributed.tp``) on the CPU over gloo process groups, against one
device, and the pieces of the cross-rank decode merge.

The reduced granite-3-2b, phi3.5-moe, mamba2-780m and zamba2-7b (fp32),
from the JAX reference's parameters (drawn here, carried across by
``convert.lm_params_to_torch`` in each rank), serve a prompt of 4 x 32
tokens and 8 greedy decode steps on a (2, 2) and a (1, 4) ("data",
"model") mesh, with the weights placed by ``param_specs`` in both its
modes (ZeRO-3, and "inference": "model" only): every step's logits and
every cache leaf within 1e-6 of the largest |value| of the unsharded
steps' (or twice the JAX reference's own spread under 1-ulp moves of the
weights where that is larger: 8.7e-7 on the logits and 1.27e-6 on the
cache at most, ``tools/port_tp_serve_spread.py``), the greedy tokens
equal, and each cache shard the shape that ``cache_specs`` gives it
(``torch_dist_worker.tp_serve``; ~7 s a test); the same with
``cfg.seq_shard``, the prefill's residual stream each rank's slice of the
prompt. On a one-rank mesh every
number is the unsharded steps', bitwise. Measured: 2.6e-7 to 1.01e-6 of
the largest (zamba2-7b's logits the farthest: the row-parallel products'
partial sums and the slices' merge round at other places). Each rank's
shards are also held to the JAX reference's own prefill and decode steps
on the same parameters and prompt (``reference_serve``, fed its own
greedy tokens, which must be the port's): every step's logits and the
final cache within twice the port's one-device gap to the reference plus
the limits above (``torch_dist_worker.reference_limits``); measured 9.05e-7
and 7.43e-7 of the largest at most.

The merge's pieces run in this process: K5's log-sum-exp plain version on
a slice with no live position returns o = 0 and lse = -inf (so the merge
weights it 0), and the per-slice plain results merged in rank order equal
``flash_decode_plain`` over the whole cache within 1e-6 of the largest.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.distributed import tp
from repro_torch.kernels.flash_decode.ref import (flash_decode_lse_plain,
                                                  flash_decode_plain,
                                                  merge_partials)
from torch_dist_worker import (SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                               TP_ARCHS, TP_MESHES, run_ranks, save_params)

torch.set_num_threads(1)
TIMEOUT = 240


def reference_serve(model, params):
    """The JAX reference's prefill of the worker's prompt and SERVE_STEPS
    greedy decode steps: each step's logits, the tokens fed and the final
    cache, as ``torch_dist_worker.load_reference`` reads them."""
    cfg = model.cfg
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, b: model.prefill(
        p, b, max_seq=SERVE_PROMPT + SERVE_STEPS))
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
    steps, fed = {"0": np.asarray(logits)}, {}
    for i in range(SERVE_STEPS):
        tok = np.asarray(logits[:, -1, :cfg.vocab].argmax(-1))[:, None]
        fed[str(i)] = tok.astype(np.int32)
        logits, cache = decode(params, cache, jnp.asarray(fed[str(i)]))
        steps[str(i + 1)] = np.asarray(logits)
    return {"logits": steps, "fed": fed, "cache": jax.device_get(cache)}


@pytest.fixture(scope="module")
def ref_params(tmp_path_factory):
    """The reference's parameters of each reduced config, drawn from
    PRNGKey(0), and its serve on them (``reference_serve``), as ``.npz``
    files the ranks load."""
    d = tmp_path_factory.mktemp("serve_params")
    for arch, name in TP_ARCHS.items():
        model = j_build_model(j_get_config(name).reduced())
        params = jax.device_get(model.init(jax.random.PRNGKey(0)))
        save_params(params, d / f"params_{arch}.npz")
        save_params(reference_serve(model, params), d / f"ref_{arch}.npz")
    return d


def _with_params(src, tmp_path):
    for f in src.iterdir():
        shutil.copy(f, tmp_path / f.name)
    return tmp_path


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("arch", sorted(TP_ARCHS))
def test_tp_prefill_and_decode_are_the_single_device_steps(
        arch, mesh, ref_params, tmp_path):
    outs = run_ranks(f"tp_serve:{arch}/{mesh}", 4,
                     _with_params(ref_params, tmp_path), TIMEOUT)
    for out in outs:
        assert out.count("greedy tokens equal") == 2, out


def test_one_rank_mesh_serve_is_bitwise_the_unsharded_steps(ref_params,
                                                            tmp_path):
    outs = run_ranks("tp_serve_one_rank", 1,
                     _with_params(ref_params, tmp_path), TIMEOUT)
    assert outs[0].count("bitwise") == len(TP_ARCHS), outs[0]


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("arch", sorted(TP_ARCHS))
def test_seq_shard_prefill_and_decode_are_the_single_device_steps(
        arch, mesh, ref_params, tmp_path):
    """The prefill with ``cfg.seq_shard`` (the residual stream each "model"
    rank's slice of the prompt, K/V and the scan on the gathered prompt,
    the cache laid out as without it) and the decode steps after it, at
    the same limits against one device and the reference."""
    outs = run_ranks(f"tp_serve:{arch}/{mesh}/seq", 4,
                     _with_params(ref_params, tmp_path), TIMEOUT)
    for out in outs:
        assert out.count("greedy tokens equal") == 2, out


def test_one_rank_mesh_seq_shard_serve_is_bitwise_the_unsharded_steps(
        ref_params, tmp_path):
    outs = run_ranks("tp_serve_one_rank:seq", 1,
                     _with_params(ref_params, tmp_path), TIMEOUT)
    assert outs[0].count("bitwise") == len(TP_ARCHS), outs[0]


def _decode_inputs(b, s, h, hkv, d, seed, scale=2.0):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std)
                                .astype(np.float32))
    return t(b, 1, h, d, std=scale), t(b, s, hkv, d), t(b, s, hkv, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("offset,pos", [(64, 63), (64, 0), (128, 100)])
def test_a_slice_with_no_live_position_gives_zero_and_minus_inf(
        dtype, offset, pos):
    q, k, v = _decode_inputs(2, 32, 4, 2, 32, offset + pos)
    o, lse = flash_decode_lse_plain(q, k.to(dtype), v.to(dtype),
                                    torch.tensor(pos, dtype=torch.int32),
                                    offset=offset)
    assert o.dtype == lse.dtype == torch.float32
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, -torch.inf))


@pytest.mark.parametrize("b,s,h,hkv,d", [(2, 64, 4, 2, 32),
                                         (1, 96, 8, 1, 64),
                                         (3, 48, 6, 6, 16)])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_slices_merged_in_rank_order_are_the_whole_cache(b, s, h, hkv, d,
                                                         ranks, where):
    """K5's log-sum-exp plain version over each rank's slice of the cache,
    merged as TP decode merges them, against ``flash_decode_plain`` over
    the whole cache: ``pos`` in the first slice (every other slice empty),
    in a middle one, in the last."""
    q, k, v = _decode_inputs(b, s, h, hkv, d, s + ranks)
    sl = s // ranks
    pos = {"first": sl // 2, "middle": s // 2 + 1, "last": s - 1}[where]
    pos = torch.tensor(pos, dtype=torch.int32)
    parts = [flash_decode_lse_plain(q, k[:, r * sl:(r + 1) * sl],
                                    v[:, r * sl:(r + 1) * sl], pos,
                                    offset=r * sl) for r in range(ranks)]
    got = merge_partials(torch.stack([o for o, _ in parts]),
                         torch.stack([lse for _, lse in parts]))
    want = flash_decode_plain(q, k, v, pos)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err


@pytest.mark.parametrize("n,m", [(40, 4), (288, 4), (288, 16), (7, 4),
                                 (3, 4), (7296, 16)])
def test_chunk_ranges_split_as_torch_chunk(n, m):
    sizes = [len(c) for c in torch.arange(n).chunk(m)]
    sizes += [0] * (m - len(sizes))
    got = tp.chunk_ranges(n, m)
    assert [hi - lo for lo, hi in got] == sizes
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_regroup_takes_a_piece_from_its_own_rank_first():
    """Every rank computes B and C of the convolution tail; a rank whose
    cache chunk holds them takes its own, the x channels come from the
    rank that computes them."""
    have = (((0, 4), (8, 12)), ((4, 8), (8, 12)))
    need = (((0, 6),), ((6, 12),))
    plan = tp._regroup_plan(have, need)
    assert plan[0] == [(0, 0, 4), (1, 4, 6)]
    assert plan[1] == [(1, 6, 8), (1, 8, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn])
@pytest.mark.parametrize("at", [-3, 0, 5, 9, 10])
def test_write_at_writes_only_a_position_of_the_slice(dtype, at):
    cache = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(
        2, 10, 3).div(8).to(dtype)
    before = cache.clone()
    new = torch.full((2, 1, 3), -1.5)
    tp.write_at(cache, new, torch.tensor(at, dtype=torch.int32))
    want = before.float()
    if 0 <= at < 10:
        want[:, at] = new[:, 0].to(dtype).float()
    assert torch.equal(cache.float(), want)
    assert cache.dtype == dtype
