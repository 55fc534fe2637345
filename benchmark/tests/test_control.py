"""The correctness check's control, which must come out not correct: the
float8 reference put in the program's place, and the planted faults. At a
tiny size on the CPU against the tiny size's limits; at the cells' own
size on the card (``cuda``) against the cells' limits."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

TRAIN = ["ml20m_128.train", "bert_base_512.train"]


def _fails(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items())


def _readings(cell, seed, device, adjust=None):
    _, _, conf, traffic = harness.cell(cell)
    if adjust is not None:
        adjust(conf, traffic)
    return (control.readings(conf, traffic, seed, torch.device(device)),
            conf["limits"])


@pytest.mark.parametrize("cell", TRAIN)
def test_control_and_half_batch_fail_at_a_tiny_size(cell):
    got, limits = _readings(cell, 5, "cpu", tiny.adjust)
    assert _fails(got["control_fp8"], limits), got
    assert _fails(got["half_batch"], limits), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [301, 302, 303])
@pytest.mark.parametrize("cell", TRAIN)
def test_control_fails_at_the_cell_size(card, cell, seed):
    got, limits = _readings(cell, seed, card)
    assert _fails(got["control_fp8"], limits), got
