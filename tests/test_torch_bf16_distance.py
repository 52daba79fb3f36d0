"""The port's bf16 LM forward against the JAX reference's bf16 forward on
the CPU, at the reduced zamba2-7b config (the comparison that
tools/port_bf16_distance.py makes at full width): same weights, carried
across by ``convert.lm_params_to_torch``, and the same numpy-made tokens.

Tolerance: bf16 keeps 8 significant bits, so each cast rounds by up to
2^-9 (1.95e-3) of its value, and the two packages cast at other places
(the reference's attention rounds its scores in the compute type; the
port follows the TPU kernels' fp32 scores, ROADMAP.md queue 3). Over the
reduced config's 4 layer positions the largest logit difference measured
1.136e-2 to 1.400e-2 of the largest logit (seeds 0-2, B = 2, S = 64 and
128), so it is held to 3e-2; the argmax, which random weights leave near
ties, agreed at 96.9-99.2 % of the positions, held to 90 %."""
import pathlib
import sys

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from tools.port_bf16_distance import bf16_distance  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

REL_TOL = 3e-2
AGREE_MIN = 0.9


@pytest.mark.parametrize("seed,seq", [(0, 64), (1, 128)])
def test_bf16_forward_lies_near_the_reference(seed, seq):
    torch.set_num_threads(1)
    rel, agree, n = bf16_distance(j_get_config("zamba2-7b").reduced(),
                                  get_config("zamba2-7b").reduced(), 2, seq,
                                  seed)
    assert 0.0 < rel <= REL_TOL   # bf16 rounds: the two are not bitwise
    assert agree >= AGREE_MIN * n
