"""A configuration that names another family runs through the same runners.

A test-only family module, registered as portbench.family_stub, delegates
every part of the family contract (families.py) to the Whisper family and
counts its calls. A tiny training cell and a tiny serving cell whose
configuration names "stub" have to reach the weights, the reference and,
through the window's `family`, the FLOP arithmetic by the stub, and read
what the same cell reads through the Whisper family on the same seed, the
numbers compared and `correct` alike (at this size the cell's limits do
not decide: test_faults.py). A reader of the stub's own (what a new
family's portbench/metrics/<name>.py would be) is served in place of a
file."""
import collections
import functools
import sys
import types

import pytest

from portbench import family_whisper as FW
from portbench import harness as H
from portbench import run as RUN
from portbench.tests.tiny import tiny_cell

SEED = 2147483711
PARTS = ("dims", "make_weights", "make_adapters", "leaves", "train_steps", "served_gaps",
         "train_step_flops", "encoder_flops", "cross_kv_flops", "decode_position_flops",
         "injected", "reference_opts", "check_program_settings", "check_config",
         "port_matches")


def _stub(counts) -> types.ModuleType:
    mod = types.ModuleType("portbench.family_stub")

    def counted(name):
        part = getattr(FW, name)

        @functools.wraps(part)
        def call(*a, **k):
            counts[name] += 1
            return part(*a, **k)
        return call
    for name in PARTS:
        setattr(mod, name, counted(name))
    mod.PREFIX, mod.EOT = FW.PREFIX, FW.EOT
    return mod


def _flops(w):
    """Useful FLOPs of the window, as a new family's mfu reader takes them."""
    f = w.family
    if w.kind == "train":
        return f.train_step_flops(w.n, w.batch, w.label_len, w.mode) * w.steps or None
    return sum(f.encoder_flops(w.n, w.batch) + f.cross_kv_flops(w.n, w.batch)
               + sum(f.decode_position_flops(w.n, w.batch, p) for p in range(steps))
               for steps in w.positions_window) or None


CASES = {
    "v3-peft-int8-b16": ("dims", "make_weights", "make_adapters", "train_steps", "injected",
                         "reference_opts", "check_program_settings", "train_step_flops"),
    "v3-greedy-b32": ("dims", "make_weights", "served_gaps", "injected", "encoder_flops",
                      "cross_kv_flops", "decode_position_flops"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_cell_of_another_family_runs_through_its_module(monkeypatch, name):
    counts = collections.Counter()
    monkeypatch.setitem(sys.modules, "portbench.family_stub", _stub(counts))
    real_read = H.read_metric
    monkeypatch.setattr(H, "read_metric",
                        lambda m, w: _flops(w) if m == "flops.stub" else real_read(m, w))
    cell = tiny_cell(name)
    cell["config"]["family"] = "stub"
    cell["per_layer"].append({"name": "flops.stub", "unit": "FLOP"})
    # a window of one step or batch, so that both runs check the same rows
    line = RUN.run_cell(cell, SEED, 0.0, True, device="cpu")
    plain = RUN.run_cell(tiny_cell(name), SEED, 0.0, False, device="cpu")
    assert line["checks"] == plain["checks"]
    assert line["correct"] == plain["correct"]
    assert line["metrics"]["flops.stub"]["value"] > 0
    assert all(counts[p] for p in CASES[name]), counts
