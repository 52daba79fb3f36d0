"""``examples/port_serve_lm.py`` and ``examples/port_train_lm.py`` against
the reference's ``serve_lm.py`` and ``train_lm.py`` on the CPU, with small
forwarded arguments.

Each script runs as ``__main__`` in a subprocess
(``tests/torch_examples_runner.py`` records what its launcher returned),
the reference's with ``JAX_PLATFORMS=cpu`` and the port's with
``--device cpu``, side by side. The port draws its own random weights, so
the pairs compared number for number start from the reference's:
  * serve (reduced musicgen-large, 4 requests of 4 new tokens at the
    launcher's temperature 0.8): the port's model starts from the
    reference's ``init(PRNGKey(0))``; completions token for token, engine
    stats and the KV sizer's sources and ``offset_idx`` equal, allocations
    within 1e-2 (``tests/test_torch_serve.py``'s limits); the script's
    own run, on its own weights, prints the reference's counts;
  * train (reduced granite-3-2b, 3 steps of 2 x 64 tokens, ``--sizey``):
    both resume from one step-0 checkpoint holding the reference trainer's
    own initial state, each in its own ``--ckpt-dir``; losses and gradient
    norms within 1e-5 of the reference's (``PERF.md`` §2's training row),
    the Sizey allocation line equal.
"""
from __future__ import annotations

import json
import os
import pathlib
import pickle
import re
import shutil
import subprocess
import sys

import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.launch import train as j_launch
from repro.models import build_model as j_build_model
from repro.train import checkpoint as j_ckpt
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainerConfig as JTrainerConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}
RUNNER = str(REPO / "tests" / "torch_examples_runner.py")
SERVE_ARGS = ["--requests", "4", "--max-new", "4"]
TRAIN_ARGS = ["--scale", "reduced", "--steps", "3", "--batch", "2",
              "--seq", "64"]
ALLOC_RTOL = 1e-2
LOSS_RTOL = 1e-5


def launch(cmd: list[str], env: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *cmd], cwd=REPO,
                            env={**ENV, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(procs: dict[str, subprocess.Popen]) -> dict[str, str]:
    outs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-3000:]}"
        outs[name] = out
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm")
    # the reference's serve weights, as its launcher draws them
    cfg = j_get_config("musicgen-large").reduced()
    params = jax.device_get(j_build_model(cfg).init(jax.random.PRNGKey(0)))
    with open(out / "params.pkl", "wb") as fh:
        pickle.dump(params, fh)
    # one step-0 checkpoint: the reference trainer's own initial state
    tcfg = j_launch.scaled_config(j_get_config("granite-3-2b"), "reduced")
    init = JTrainer(tcfg, JTrainerConfig(steps=0, global_batch=2,
                                         seq_len=64))
    j_ckpt.save(str(out / "ckpt_ref"), 0,
                {"params": init.params, "opt": init.opt_state})
    shutil.copytree(out / "ckpt_ref", out / "ckpt_port")
    procs = {
        "serve_ref": launch([RUNNER, "serve", str(out / "serve_ref.json"),
                             "examples/serve_lm.py", *SERVE_ARGS]),
        "serve_port": launch([RUNNER, "serve", str(out / "serve_port.json"),
                              "examples/port_serve_lm.py", *SERVE_ARGS,
                              "--device", "cpu"],
                             {"REFERENCE_PARAMS": str(out / "params.pkl")}),
        "serve_own": launch(["examples/port_serve_lm.py", *SERVE_ARGS,
                             "--device", "cpu"]),
        "train_ref": launch([RUNNER, "train", str(out / "train_ref.json"),
                             "examples/train_lm.py", *TRAIN_ARGS,
                             "--ckpt-dir", str(out / "ckpt_ref")]),
        "train_port": launch([RUNNER, "train", str(out / "train_port.json"),
                              "examples/port_train_lm.py", *TRAIN_ARGS,
                              "--ckpt-dir", str(out / "ckpt_port"),
                              "--device", "cpu"]),
    }
    logs = finish(procs)
    rec = {name: json.loads((out / f"{name}.json").read_text())
           for name in ("serve_ref", "serve_port", "train_ref",
                        "train_port")}
    return logs, rec


def test_served_tokens_and_kv_sizing_are_the_reference(runs):
    logs, rec = runs
    ref, port = rec["serve_ref"], rec["serve_port"]
    assert port["completions"] == ref["completions"]
    assert len(ref["completions"]) == 4
    assert all(len(toks) == 4 for _, _, toks in ref["completions"])
    assert port["stats"] == ref["stats"]
    assert [d[:2] for d in port["decisions"]] == \
        [d[:2] for d in ref["decisions"]]
    for (_, _, a), (_, _, b) in zip(port["decisions"], ref["decisions"]):
        assert abs(a - b) <= ALLOC_RTOL * abs(b)


def _counts(line: str) -> str:
    """The serve line without its wall, rate and device."""
    return re.sub(r" in [\d.]+s \([\d.]+ tok/s\)( on \S+)?,", ",", line)


def test_the_scripts_print_the_reference_counts(runs):
    logs, _ = runs
    for name in ("serve_port", "serve_own"):
        got = [ln for ln in logs[name].splitlines() if ln.strip()]
        want = [ln for ln in logs["serve_ref"].splitlines() if ln.strip()]
        assert len(got) == len(want) == 2, name
        assert _counts(got[0]) == _counts(want[0]), name
        assert got[0].split("completions")[0] == "4 "
        assert "on cpu," in got[0]
        # KV sizing decisions: count and last source equal; the allocation
        # printed to 3 places
        pat = r"KV sizing decisions: (\d+) \(last source=(\w+), alloc=([\d.]+)"
        (gn, gs, ga), (wn, ws, wa) = (re.search(pat, x).groups()
                                      for x in (got[1], want[1]))
        assert (gn, gs) == (wn, ws)
        assert abs(float(ga) - float(wa)) <= ALLOC_RTOL * float(wa) + 1e-3


def test_training_losses_are_the_reference(runs):
    logs, rec = runs
    ref, port = rec["train_ref"]["history"], rec["train_port"]["history"]
    assert [h["step"] for h in port] == [h["step"] for h in ref] == [0, 1, 2]
    for a, b in zip(port, ref):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= LOSS_RTOL * abs(b[key]), (a, b)
    sizey = [ln for ln in logs["train_ref"].splitlines()
             if ln.startswith("Sizey allocation")]
    assert sizey and [ln for ln in logs["train_port"].splitlines()
                      if ln.startswith("Sizey allocation")] == sizey
    assert any(ln.startswith("done: final loss")
               for ln in logs["train_port"].splitlines())


def test_train_wrapper_keeps_its_own_checkpoint_directory():
    import runpy
    port = runpy.run_path(str(REPO / "examples" / "port_train_lm.py"),
                          run_name="example")
    assert os.path.basename(port["CKPT_DIR"]) == "repro_torch_e2e_ckpt"
    ref = (REPO / "examples" / "train_lm.py").read_text()
    assert port["CKPT_DIR"] not in ref and "/tmp/repro_e2e_ckpt" in ref
    got = []
    g = port["main"].__globals__
    g["train_main"] = lambda argv: got.append(argv)
    g["main"](["--quick", "--device", "cpu", "--steps", "9"])
    assert got[-1][-2:] == ["--device", "cpu"] and "9" not in got[-1]
    assert got[-1][got[-1].index("--ckpt-dir") + 1] == port["CKPT_DIR"]
    g["main"](["--steps", "9", "--device", "cpu"])
    assert got[-1][-4:] == ["--steps", "9", "--device", "cpu"]
