"""The control: the next precision down in the program's place, at the
cell's own size on the card, must come out as not correct (one of the
cell's numbers over its limit) on every seed, here three. Marked cuda: on
the CPU it skips."""
import pytest

from portbench import run as RUN

CELLS = ["v3-peft-int8-b16", "small-full-specaug-b32", "v3-greedy-b32"]
SEEDS = [2147483701, 2147483723, 2147483743]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    for line in RUN.control(RUN.load_cell(cell), SEEDS, "lower", "cuda"):
        assert any(c["value"] > c["limit"] for c in line["checks"].values()), line
