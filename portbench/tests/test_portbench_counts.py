"""The benchmark's FLOP and byte counts against hand counts."""
import json
import os

import pytest

from portbench.harness import flops, peaks
from portbench.reference.model import dims
from portbench.tests.tiny import ROOT


def _dims(name):
    with open(os.path.join(ROOT, f"portbench/configs/{name}.json")) as f:
        return dims(json.load(f))


def test_uc2_forward_flops_by_hand():
    # a layer over S = 76: q, k, v, o 4 x 2 x 76 x 768^2 = 358,612,992; FFN
    # 2 x 2 x 76 x 768 x 3072 = 717,225,984; QK^T and PV 4 x 76^2 x 768 =
    # 17,743,872; 12 layers 13,122,994,176. Regions 2 x 36 x (2048 + 7) x
    # 768 = 113,633,280; pooler and classifier 2 x (768^2 + 768^2 + 768 x
    # 1842) = 5,188,608.
    assert flops.forward_flops(_dims("uc2")) == 13_241_816_064
    assert flops.train_flops(_dims("uc2")) == 3 * 13_241_816_064


def test_m3p_forward_flops_by_hand():
    # S = 140: a layer 2 x 140 x (4 x 768^2 + 2 x 768 x 3072) + 4 x 140^2 x
    # 768 = 1,981,808,640 + 60,211,200; 12 layers 24,504,238,080. Regions 2 x
    # 100 x (2048 + 5) x 768 = 315,340,800; head 2 x (768^2 + 768 x 1536 +
    # 1536 x 1842) = 9,197,568.
    assert flops.forward_flops(_dims("m3p")) == 24_828_776_448


def test_attention_core_bound_at_uc2_training_shapes():
    # B1 at [128, 76, 768] bf16, 14,942,208 bytes an operand: forward 4 of
    # them + the 38,912-byte bias, 4 x 128 x 12 x 76^2 x 64 FLOPs; backward 7
    # + twice the bias, 10 x ...; both bound by bytes: 0.0179 + 0.0312 ms
    fb, fo = flops.attention_core(128, 76, 12, 64, 2, False)
    bb, bo = flops.attention_core(128, 76, 12, 64, 2, True)
    assert (fb, fo) == (59_807_744, 2_271_215_616)
    assert (bb, bo) == (104_673_280, 5_678_039_040)
    least = peaks.bound_s(fb, fo) + peaks.bound_s(bb, bo)
    assert least * 1e3 == pytest.approx(0.0491, abs=5e-5)
