"""The paper's evaluation through the port against the reference's
``benchmarks/run.py`` on mag at scale 0.05 (8 task types, pools of up to
39 tasks; at 0.35 its pools pass the history buffers' first 128 rows): the
numpy baselines' table2, fig8c and fig8d entries equal, Sizey's within the
0.05 limits of ``tools/port_paper_reference.json``, every job's record
within its job limits, and fig12's keys and
types the reference's (fig12 read at 0.05 here; the harness reads it at
``max(scale, 0.3)``, as the reference does). On the CPU.
"""
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import benchmarks.run as brun  # noqa: E402
from repro_torch.workflow import paper  # noqa: E402
from test_torch_paper import (REFERENCE, SCALE,  # noqa: E402
                              assert_baselines_equal,
                              assert_same_keys_and_types,
                              assert_sizey_within, run_both, table_figures,
                              tool)


@pytest.fixture(scope="module")
def mag():
    jobs = [("mag", SCALE, m, 1.0, None) for m in paper.METHODS]
    return run_both("mag", jobs)


def test_numpy_baselines_equal_on_mag(mag):
    got, want = table_figures(*mag)
    assert_baselines_equal(got, want, "mag")


def test_sizey_within_the_reference_limits_on_mag(mag):
    got, _want = table_figures(*mag)
    assert_sizey_within(got, mag[0], "mag")


def test_every_job_within_its_limits_on_mag(mag):
    assert tool.compare_jobs(mag[0].records, REFERENCE) == []


def test_fig12_keys_and_types_match_the_reference(mag):
    grid, _ref = mag
    got, want = {}, {}
    tool.fig12(grid, SCALE, got)
    brun.bench_fig12(SCALE, want)
    assert_same_keys_and_types(got["fig12"], want["fig12"])
    f12 = got["fig12"]
    assert f12["n"] > 2 and f12["late_median_rel_err"] > 0
