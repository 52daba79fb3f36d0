"""End-to-end training on the PyTorch/CUDA port (``examples/train_lm.py``
over ``repro_torch``): train a ~100M-parameter LM for a few hundred steps
with checkpoint/restart and Sizey-sized memory.

    # ~100M parameters, 300 steps, on the card
    PYTHONPATH=src python examples/port_train_lm.py
    # the quick variant (40 steps of 4 x 128 tokens)
    PYTHONPATH=src python examples/port_train_lm.py --quick
    # a reduced configuration on a machine without a GPU
    PYTHONPATH=src python examples/port_train_lm.py --scale reduced \\
        --steps 3 --batch 2 --seq 64 --device cpu

Arguments go to ``repro_torch.launch.train`` (``--help`` lists them);
``--quick`` takes only ``--device`` beside it, as the reference's takes
nothing. The default checkpoint directory is this package's own
(``repro_torch_e2e_ckpt`` in the temporary directory): the trainer
resumes from any checkpoint it finds there, so it must not be the
reference's.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_e2e_ckpt")


def _device_args(argv: list[str]) -> list[str]:
    """The ``--device`` arguments of ``argv``, in either spelling."""
    out = []
    for i, a in enumerate(argv):
        if a.startswith("--device="):
            out.append(a)
        elif a == "--device" and i + 1 < len(argv):
            out += argv[i:i + 2]
    return out


def main(argv: list[str]):
    if "--quick" in argv:
        args = ["--arch", "granite-3-2b", "--scale", "e2e-100m",
                "--steps", "40", "--batch", "4", "--seq", "128",
                "--ckpt-dir", CKPT_DIR, "--sizey"] + _device_args(argv)
    else:
        args = ["--arch", "granite-3-2b", "--scale", "e2e-100m",
                "--steps", "300", "--batch", "8", "--seq", "256",
                "--ckpt-dir", CKPT_DIR, "--sizey"]
        args += argv
    return train_main(args)


if __name__ == "__main__":
    main(sys.argv[1:])
