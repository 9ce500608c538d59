"""The timed path broken underneath a run, which the comparison has to
catch: each fault a cell can have, driven through the rest of a run on the
CPU at a tiny size (the chip look skipped), with the cell's own limits.
One chip, so no exchange between chips to leave out.

At this size bf16's rounding reads larger than at the cell's own, so the
test asks of a fault that it raise one of the cell's numbers over its
limit and to three times what the same run without the fault reads."""
import functools

import pytest

from portbench import run as RUN
from portbench.tests.tiny import tiny_cell

SEED = 2147483693
FAULTS = [("v3-peft-int8-b16", "unchanged_state"), ("v3-peft-int8-b16", "half_batch"),
          ("small-full-specaug-b32", "unchanged_state"),
          ("small-full-specaug-b32", "half_batch"), ("v3-greedy-b32", "altered_token")]


@functools.lru_cache(maxsize=None)
def _sound(cell: str) -> dict:
    return RUN.run_cell(tiny_cell(cell), SEED, 0.5, False, device="cpu")["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault):
    line = RUN.run_cell(tiny_cell(cell), SEED, 0.5, False, device="cpu", faults=(fault,))
    assert not line["correct"]
    sound = _sound(cell)
    caught = [k for k, c in line["checks"].items()
              if c["value"] > c["limit"] and c["value"] >= 3 * sound[k]["value"]]
    assert caught, (line["checks"], sound)
