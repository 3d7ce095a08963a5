"""The control fails the check: the reference in the precision below the
one the cell states, put in the program's place (fp8 operands for the
bf16 kernels' cells, TF32 for the f32 networks' cell), at a tiny width;
on the card at the cell's own size it is ``benchmark.calibrate``."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _control_numbers(workload, device):
    cell = tiny.cell(workload)
    res = harness.run(cell, 2 ** 31 + 3, 0.2, False, device, t_process=lambda: 0.0,
                      controls=True)
    return cell, res["readings"]["control"]


def _fails(cell, numbers):
    limits = cell["limits"]["limits"]
    return any(numbers[n] > limits[n] for n in limits if n in numbers)


@pytest.mark.parametrize("workload", ["neus_global.fused", "neus_virtual.planned"])
def test_fp8_control_fails(workload):
    cell, numbers = _control_numbers(workload, torch.device("cpu"))
    assert _fails(cell, numbers), numbers


@pytest.mark.cuda
def test_tf32_control_fails(cuda_device):
    cell, numbers = _control_numbers("neus_global.autograd", cuda_device)
    assert _fails(cell, numbers), numbers
