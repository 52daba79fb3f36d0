"""Run an LM example script (``examples/serve_lm.py``, ``train_lm.py`` or
the port's ``port_serve_lm.py``, ``port_train_lm.py``) as ``__main__`` and
write what its launcher returned as JSON, for the tests that hold the
port's scripts to the reference's.

    python tests/torch_examples_runner.py serve|train OUT SCRIPT [ARGS...]

``serve`` records each completion's tokens, the engine's stats and the KV
sizer's decisions; ``train`` each step's loss and gradient norm. With
``REFERENCE_PARAMS=PATH`` (a pickle of the reference's parameter tree as
numpy arrays) the port's model starts from those parameters instead of
its own draws, as the tests compare the two packages on one set of
weights.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import runpy
import sys


def _port_params_from(path: str) -> None:
    from repro_torch.convert import lm_params_to_torch
    from repro_torch.models import model
    with open(path, "rb") as fh:
        tree = pickle.load(fh)

    def init_params(cfg, seed=0, device=None):
        return lm_params_to_torch(tree, device)
    model.init_params = init_params


def main() -> int:
    mode, out, script, *args = sys.argv[1:]
    pkg = "repro_torch" if os.path.basename(script).startswith("port_") \
        else "repro"
    if pkg == "repro_torch":
        import torch
        torch.set_num_threads(1)
        if os.environ.get("REFERENCE_PARAMS"):
            _port_params_from(os.environ["REFERENCE_PARAMS"])
    launch = importlib.import_module(f"{pkg}.launch.{mode}")
    got = {"completions": []}
    real = launch.main
    engine = importlib.import_module(f"{pkg}.serving.engine").ServeEngine
    serve = engine.serve

    def recording(self, requests):
        out = serve(self, requests)
        got["completions"] += out
        return out
    engine.serve = recording

    def capture(argv=None, **kw):
        got["result"] = real(argv, **kw)
        return got["result"]
    launch.main = capture
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    r = got["result"]
    if mode == "serve":
        record = {
            "completions": [[int(c.rid), int(c.prompt_len),
                             [int(t) for t in c.tokens]]
                            for c in got["completions"]],
            "stats": {k: int(v) for k, v in r.stats.items()},
            "decisions": [[d.source, int(d.offset_idx),
                           float(d.allocation_gb)]
                          for d in r.sizer.decisions]}
    else:
        record = {"history": [{"step": int(h["step"]),
                               "loss": float(h["loss"]),
                               "grad_norm": float(h["grad_norm"])}
                              for h in r.history]}
    with open(out, "w") as fh:
        json.dump(record, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
