#!/usr/bin/env python3
"""Where one call of K1, K2 and K3 spends its time on the card: the loop
time per call (CUDA events over back-to-back calls), the kernel's device
time (torch.profiler) and the host's time to issue the call (perf_counter
over calls without a synchronise), at the shapes the methylseq replays
launch (K3: a boundary fit at chip_smoke.py's K3_TIMED, G = 32, k = 4).

    python3 tools/port_host_split.py [--src DIR]

``--src`` imports the port from another checkout's ``src`` (for example an
earlier commit unpacked with ``git archive``), so that two versions are
timed on one card; run them in turns (A, B, B, A). Each K1 row times
``ensemble_mlp_forward`` (the forward alone) and the MLP model's predict as
five launches (the eager normalisation, the forward and the eager
de-normalisation), and, where the port has it, the fused predict
``mlp_predict`` (one launch). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# the replays' shapes (chip_smoke.py phases 4-5 on methylseq at scale 1.0):
# K1 (M, T, d, h) and K2 (Q, T, d)
K1_SHAPES = [(1, 1, 1, 32), (1, 128, 1, 32), (1, 256, 1, 32), (1, 4, 2, 32),
             (1, 128, 2, 32), (1, 256, 2, 32), (1, 512, 2, 32),
             (1, 1024, 2, 32)]
K2_SHAPES = [(1, 128, 1), (128, 128, 1), (256, 256, 1), (4, 128, 2),
             (4, 256, 2), (4, 512, 2), (128, 128, 2), (256, 256, 2),
             (512, 512, 2), (1024, 1024, 2), (1024, 1024, 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="the src directory to import the port from")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs   # the timing helpers and the inputs
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("port_host_split: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ensemble_mlp import ops as k1ops
    from repro_torch.kernels.knn.ops import knn_predict
    from repro_torch.kernels.segment_dp.ops import fit_cuts
    import repro_torch
    print(f"[split] {cs.gpu_line()}; the port from "
          f"{pathlib.Path(repro_torch.__file__).parents[1]}")
    dev = torch.device("cuda")
    fused = getattr(k1ops, "mlp_predict", None)

    def line(what, fn, match):
        print(f"[split] {what}: loop {cs._time_ms(fn):.5f} ms, device "
              f"{cs._fmt_ms(cs._device_ms(fn, match))}, host "
              f"{cs._host_ms(fn):.5f} ms", flush=True)

    for m, t, d, h in K1_SHAPES:
        fwd = cs._k1_inputs(m, t, d, h, 7, dev)
        line(f"ensemble_mlp_forward (M,T,d,h)={(m, t, d, h)}",
             lambda: k1ops.ensemble_mlp_forward(*fwd), "ensemble_mlp_kernel")
        pred = cs._mlp_predict_inputs(t, d, h, 7, dev)
        line(f"predict as 5 launches (M,T,d,h)={(m, t, d, h)}",
             lambda p=pred: cs._composed_predict(*p), None)
        if fused is not None:
            line(f"predict fused, 1 launch (M,T,d,h)={(m, t, d, h)}",
                 lambda p=pred: fused(*p), None)
    plans = "splits" in inspect.signature(knn_predict).parameters
    for q, t, d in K2_SHAPES:
        qs, hist, ys, mask, scale = cs._k2_inputs(q, t, d, 11, dev, False)
        line(f"knn_predict (Q,T,d)={(q, t, d)} k=5"
             + (" (planned warps a query)" if plans else ""),
             lambda: knn_predict(qs, hist, ys, mask, scale, 5),
             "knn_predict_kernel")
    # the first design's kernel was segment_dp_kernel, the redesign's
    # segment_dp_fit_kernel
    for m in cs.K3_TIMED:
        P = torch.from_numpy(cs.k3_profiles("random", m, 32, seed=m)).to(dev)
        line(f"segment_dp (M,G,k)={(m, 32, 4)}", lambda P=P: fit_cuts(P, 4),
             "segment_dp")
    return 0


if __name__ == "__main__":
    sys.exit(main())
