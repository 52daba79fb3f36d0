"""The port's analysis layer against the reference's, on the CPU.

``model_flops`` and ``roofline_terms`` (with the reference's constants
patched into the port's module) bitwise the reference's; the HLO parser
bitwise the reference's on HLO text that jax lowers from a small sharded
function (a subprocess with 8 host devices); ``collectives.py`` on a gloo
(2, 2) mesh against a count made here; ``input_specs`` leaf for leaf the
reference's; K4-K6's fake kernels against their plain versions' shapes
and types, and their FLOP formulas against ``kernel_costs``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.analysis.roofline as j_roofline  # noqa: E402
from repro.analysis.hlo import collective_bytes as j_collective_bytes  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.launch.inputs import input_specs as j_input_specs  # noqa: E402
from repro_torch.analysis import kernel_costs  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.hlo import collective_bytes  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_backward_plain, flash_attention_plain)
from repro_torch.kernels.flash_decode.ref import flash_decode_plain  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_backward_plain, ssd_scan_plain)
from repro_torch.launch.inputs import input_specs  # noqa: E402
from repro_torch.utils.misc import tree_flatten_with_path  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.repro_torch
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_bitwise(arch, shape):
    got = roofline.model_flops(get_config(arch), SHAPES[shape])
    want = j_roofline.model_flops(j_get_config(arch), J_SHAPES[shape])
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b"])
def test_roofline_terms_bitwise_with_the_reference_constants(arch,
                                                             monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", j_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", j_mesh.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", j_mesh.ICI_BW)
    rng = np.random.default_rng(7)
    for shape in SHAPES:
        for chips in (256, 512):
            f, b, c = (float(v) for v in rng.uniform(1e9, 1e15, 3))
            for coll in (c, 0.0):
                args = (arch, shape, chips, f, b, coll, 12.5)
                got = roofline.roofline_terms(
                    arch, SHAPES[shape], get_config(arch), "single",
                    *args[2:])
                want = j_roofline.roofline_terms(
                    arch, J_SHAPES[shape], j_get_config(arch), "single",
                    *args[2:])
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.step_time_lower_bound_s \
                    == want.step_time_lower_bound_s


HLO_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
mesh = jax.make_mesh((2, 4), ("data", "model"))

def body(x, y):
    g = jax.lax.all_gather(x, "model", tiled=True)
    r = jax.lax.psum(y, "data")
    s = jax.lax.psum_scatter(x, "model", tiled=True)
    a = jax.lax.all_to_all(y, "model", 0, 0, tiled=True)
    p = jax.lax.ppermute(x, "data", [(0, 1), (1, 0)])
    return g.sum() + r.sum() + s.sum() + a.sum() + p.sum()

f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data", "model"),
                                                 P("data", None)),
                      out_specs=P(), check_rep=False))
x = jnp.ones((16, 32), jnp.float32)
y = jnp.ones((8, 12), jnp.bfloat16)
open(sys.argv[1], "w").write(f.lower(x, y).compile().as_text())
"""


def test_hlo_parser_bitwise_on_lowered_text(tmp_path):
    out = tmp_path / "hlo.txt"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", HLO_SCRIPT, str(out)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    text = out.read_text()
    got, want = collective_bytes(text), j_collective_bytes(text)
    assert got == want
    assert sum(v > 0 for v in got["counts"].values()) >= 4, got


def test_collective_counter_on_a_gloo_mesh(tmp_path):
    """Four ranks each count one collective of every kind, a DTensor
    redistribution and a point-to-point exchange; the bytes are those of
    the results, as the test computes them from the shapes."""
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, worker, "collectives", str(r), "4",
         str(tmp_path / "store"), str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(4)]
    deadline = time.monotonic() + 120
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o}"
    f32, f64, i16 = 4, 8, 2
    for r in range(4):
        got = json.load(open(tmp_path / f"collectives_{r}.json"))
        want = {
            # funcol's (6, 4) gathered over "data" and the DTensor's
            # (Shard(0), Replicate()) -> replicated: two (12, 4)
            "all-gather": 2 * 12 * 4 * f32,
            "all-reduce": 6 * 4 * f64,
            "reduce-scatter": 3 * 4 * f32,
            "all-to-all": 4 * 4 * f32,
            # even ranks receive (5, 4) int16, odd ones (2, 4) fp32
            "collective-permute": 5 * 4 * i16 if r % 2 == 0 else 2 * 4 * f32,
        }
        assert got["bytes_by_kind"] == want
        assert got["counts"] == {"all-gather": 2, "all-reduce": 1,
                                 "reduce-scatter": 1, "all-to-all": 1,
                                 "collective-permute": 1}
        assert got["total_bytes"] == sum(want.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_leaf_for_leaf(arch):
    for shape in SHAPES:
        jk, js = j_input_specs(j_get_config(arch), J_SHAPES[shape])
        tk, ts = input_specs(get_config(arch), SHAPES[shape], device="cpu")
        assert tk == jk
        jp, jl = zip(*jax.tree_util.tree_flatten_with_path(js)[0])
        tp, tl = tree_flatten_with_path(ts)
        assert [jax.tree_util.keystr(p) for p in jp] == [
            p.replace("/", "") for p in tp]
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
            assert b.device.type == "cpu" and b.__class__.__name__ \
                == "FakeTensor"


# ------------------------------------------------------ the fake kernels
def _fake_like(t, mode):
    with mode:
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device="cuda")


def _same_meta(fake, plain):
    fake = fake if isinstance(fake, tuple) else (fake,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert len(fake) == len(plain)
    for f, p in zip(fake, plain):
        assert tuple(f.shape) == tuple(p.shape)
        assert f.dtype == p.dtype and f.device.type == "cuda"


def _k4_inputs(b, s, h, hkv, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g).to(dtype)
    return q, k, v


K4_SHAPES = [(2, 64, 4, 2, 32), (1, 80, 6, 1, 64)]


@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fake_kernels(shape, dtype, causal):
    b, s, h, hkv, d = shape
    q, k, v = _k4_inputs(*shape, dtype)
    kv_len = s - 5
    scale = d ** -0.5
    out = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                       ).to(dtype)
    grads = flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                           scale=scale, kv_len=kv_len)
    lse = torch.empty((b, h, s), dtype=torch.float32)
    mode = FakeTensorMode()
    fq, fk, fv, fo, fd, fl = (_fake_like(t, mode)
                              for t in (q, k, v, out, dout, lse))
    with mode, FlopCounterMode(display=False) as fc:
        _same_meta(OPS.flash_attention(fq, fk, fv, causal, scale, kv_len),
                   out)
        _same_meta(OPS.flash_attention_lse(fq, fk, fv, causal, scale,
                                           kv_len), (out, lse))
        fwd = fc.get_total_flops()
        _same_meta(OPS.flash_attention_bwd(fq, fk, fv, fo, fd, fl, causal,
                                           scale, kv_len), tuple(grads))
    work = kernel_costs.k4_work(b, s, h, hkv, d, 2, causal, kv_len)[1]
    bwd = kernel_costs.k4_bwd_work(b, s, h, hkv, d, 2, causal, kv_len)[1]
    assert fwd == 2 * work
    assert fc.get_total_flops() == 2 * work + bwd
    assert bwd == int(2.5 * work)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_fake_kernel(dtype):
    b, s_max, h, hkv, d = 3, 96, 8, 2, 64
    g = torch.Generator().manual_seed(2)
    q = torch.randn(b, 1, h, d, generator=g).to(dtype)
    # a layer's slice of a stacked cache, as decode passes it
    kc = torch.randn(2, b, s_max, hkv, d, generator=g).to(dtype)[1]
    vc = torch.randn(2, b, s_max, hkv, d, generator=g).to(dtype)[0]
    pos = torch.tensor(40, dtype=torch.int32)
    out = flash_decode_plain(q, kc, vc, pos, scale=d ** -0.5)
    mode = FakeTensorMode()
    fq, fk, fv, fp = (_fake_like(t, mode) for t in (q, kc, vc, pos))
    with mode, FlopCounterMode(display=False) as fc:
        _same_meta(OPS.flash_decode(fq, fk, fv, fp, d ** -0.5), out)
    assert fc.get_total_flops() == kernel_costs.k5_work(
        b, h, hkv, d, s_max, 2)[1]


@pytest.mark.parametrize("shape", [(2, 3, 200, 16, 32, 64),
                                   (1, 4, 128, 64, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fake_kernels(shape, dtype):
    b, h, s, p, n, q = shape
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, s, h, p, generator=g).to(dtype)
    dt = torch.rand(b, s, h, generator=g) * 0.1
    bm = torch.randn(b, s, n, generator=g).to(dtype)
    cm = torch.randn(b, s, n, generator=g).to(dtype)
    a = -torch.rand(h, generator=g)
    y, final = ssd_scan_plain(x, dt, bm, cm, a, q_chunk=q)
    dy = torch.randn(y.shape, generator=g)
    grads = ssd_scan_backward_plain(x, dt, bm, cm, a, dy, q_chunk=q)
    mode = FakeTensorMode()
    fx, fdt, fb, fc_, fa, fdy = (_fake_like(t, mode)
                                 for t in (x, dt, bm, cm, a, dy))
    with mode, FlopCounterMode(display=False) as fc:
        _same_meta(OPS.ssd_scan(fx, fdt, fb, fc_, fa, q), (y, final))
        fwd = fc.get_total_flops()
        got = OPS.ssd_scan_bwd(fx, fdt, fb, fc_, fa, fdy, None, q)
    # the kernel returns dx, dB and dC in the inputs' type, ddt and da in
    # fp32
    _same_meta(got, tuple(t.to(w.dtype) for t, w in
                          zip(grads[:5], (x, dt, bm, cm, a))))
    assert fwd == kernel_costs.k6_work(b, h, s, p, n, q, 2)[1]
    assert fc.get_total_flops() - fwd == kernel_costs.k6_bwd_work(
        b, h, s, p, n, q, 2)[1]


def test_kernel_costs_keep_the_bounds_of_the_smoke():
    """The counts moved out of chip_smoke.py give the bounds its kernel
    table was built on (PERF.md: K4 0.2433 ms, K5 0.07070 ms, K6 0.2182
    ms, K4 bwd 0.01260 ms, K6 bwd 0.15693 ms at the recorded shapes)."""
    assert kernel_costs.k4_bound(8, 2048, 32, 32, 112, 2)[0] \
        == pytest.approx(0.2433, abs=1e-4)
    assert kernel_costs.k5_bound(8, 32, 32, 112, 2063, 2)[0] \
        == pytest.approx(0.07070, abs=1e-5)
    assert kernel_costs.k6_bound(8, 112, 2048, 64, 64, 128, 2)[0] \
        == pytest.approx(0.2182, abs=1e-4)
    assert kernel_costs.k4_bwd_bound(8, 256, 32, 8, 64, 2)[0] \
        == pytest.approx(0.01260, abs=1e-5)
    nbytes, flops, fp32 = kernel_costs.k6_bwd_work(8, 48, 1024, 64, 128,
                                                   128, 2)
    assert kernel_costs.bound_at(nbytes, flops + 2 * fp32,
                                 kernel_costs.PEAK_FLOPS_BF16)[0] \
        == pytest.approx(0.15693, abs=1e-5)
