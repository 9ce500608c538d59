"""The reference takes its settings from the program's own parsed options:
each training mix's options reach both sides, the program's adapter
defaults are the ones the reference follows, and an option the reference
does not follow stops the run instead of passing by chance."""
import copy

import pytest

from portbench import family_whisper as FW
from portbench import run as RUN
from portbench import train as T

SEED = 2147483647 + 10
CELLS = ["v3-peft-int8-b16", "small-full-specaug-b32"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_reads_the_programs_options(cell):
    c = RUN.load_cell(cell)
    args = T.parse_program_args(c, SEED, "cpu")
    opts = FW.reference_opts(args, SEED)
    assert opts["lr"] == args.learning_rate and opts["max_steps"] == args.max_steps
    assert opts["spec_augment"] == ("--spec_augment" in c["traffic"]["train"]["options"])
    assert opts["mode"] == ("peft" if "--peft" in c["traffic"]["train"]["options"] else "full")
    if opts["mode"] == "peft":
        assert opts["calibrate"] and opts["int8"] and opts["encoder_adapters"]


def test_the_programs_adapter_defaults_are_the_references():
    from asr_finetune_tpu_torch.training.lora import LoraConfig
    d = LoraConfig()
    assert (d.dropout, d.orth_reg_weight) == (FW.LORA_DROPOUT, FW.ORTH_REG_WEIGHT)


@pytest.mark.parametrize("extra", [["--label_smoothing", "0.1"], ["--warmup_steps", "5"],
                                   ["--no-int8_matmul"]])
def test_an_option_the_reference_does_not_follow_stops_the_run(extra):
    c = copy.deepcopy(RUN.load_cell("v3-peft-int8-b16"))
    c["traffic"]["train"]["options"] += extra
    with pytest.raises(ValueError):
        FW.reference_opts(T.parse_program_args(c, SEED, "cpu"), SEED)
