"""Batched serving on the PyTorch/CUDA port (``examples/serve_lm.py`` over
``repro_torch``): decoder-only audio-token model (musicgen backbone) with
Sizey-sized KV caches.

    PYTHONPATH=src python examples/port_serve_lm.py                # the card
    PYTHONPATH=src python examples/port_serve_lm.py --device cpu   # no GPU

Arguments go to ``repro_torch.launch.serve`` (``--help`` lists them);
with none, the documented musicgen demo runs on CUDA.
"""
import sys

from repro_torch.launch.serve import main as serve_main

# the reference's demo configuration
DEMO_ARGV = ["--arch", "musicgen-large", "--requests", "16",
             "--max-new", "24"]


def main(argv):
    # forward CLI args to the serving launcher (so --help and overrides
    # work); with none, run the documented musicgen demo configuration
    # (whose values are also the launcher's defaults, so ``--device cpu``
    # alone runs the demo too)
    engine = serve_main(argv or DEMO_ARGV)
    sizer = engine.sizer
    if sizer is not None and sizer.decisions:
        last = sizer.decisions[-1]
        print(f"KV sizing decisions: {len(sizer.decisions)} "
              f"(last source={last.source}, alloc={last.allocation_gb:.3f} GB)")
    return engine


if __name__ == "__main__":
    main(sys.argv[1:])
