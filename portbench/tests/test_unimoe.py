"""The Uni-MoE family (family_unimoe.py) at a tiny size on the CPU: a cell
of it runs through the same runner as every training cell and comes out
correct, loading no JAX; its reference agrees with the port's plain CPU
reference (tests/unimoe_reference.py); its control one precision down is
not correct by the cell's own limits; its configuration file is checked
whole against the published shape and the port."""
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import family_unimoe as FU
from portbench import reference as RF
from portbench import reference_unimoe as RU
from portbench import run as RUN
from portbench import train as T
from portbench import traffic as TR

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "unimoe-peft-int8-b8"
SEED = 2147483713
# the port's test-unimoe widths (models/configs.py), test-nano's encoder
TINY = {"model_type": "test-unimoe", "family": "unimoe", "reduced": [],
        "assumed": {"audio_pool": 5}, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 288,
        "rms_norm_eps": 1e-6, "rope_theta": 1e6, "shared_intermediate_size": 32,
        "mlp_fixed_expert_num": 2, "dynamic_intermediate_size": 48,
        "intermediate_size": 48, "mlp_dynamic_expert_num": 4,
        "mlp_dynamic_null_expert_num": 1, "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2,
        "whisper_hidden_size": 64,
        "whisper_encoder": {"d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 2,
                            "encoder_ffn_dim": 256, "num_mel_bins": 80,
                            "max_source_positions": 1500}}


# at this size bf16's rounding and the int8 steps of 64-wide rows read larger
# than at the cell's own (test_faults.py): limits of its own, between the
# program's readings (grad 0.086, change 0.026) and the control's (0.27, 0.087)
TINY_LIMITS = {"grad_gap": 0.15, "change_gap": 0.06, "outlier_set_diff": 0.0}


def tiny_cell(batch: int = 2, pool: int = 6) -> dict:
    """The cell at test-unimoe's widths, its special ids 272 and 273."""
    cell = copy.deepcopy(RUN.load_cell(CELL))
    cell["config"] = copy.deepcopy(TINY)
    cell["limits"] = dict(TINY_LIMITS)
    tr = cell["traffic"]
    tr["batch"], tr["pool"], tr["audio_seconds"], tr["transcript_tokens"] = \
        batch, pool, [2, 4], [20, 40]
    return cell


def _config():
    with open(os.path.join(ROOT, "portbench", "configs", "uni-moe-2.0-omni.json")) as f:
        return json.load(f)


def test_a_tiny_cell_is_correct_and_loads_no_jax():
    """One run of the cell's path on the CPU in a fresh interpreter: the
    port's trial over the benchmark's int8 trees, the checked steps, a
    window, the reference; correct, and no JAX module loaded."""
    code = ("import json, sys\n"
            "from portbench.tests.test_unimoe import tiny_cell, SEED\n"
            "from portbench import family_unimoe as FU, run as RUN\n"
            "FU.PREFIX, FU.EOT = (272,), 273\n"
            "line = RUN.run_cell(tiny_cell(), SEED, 0.0, False, device='cpu')\n"
            "print(json.dumps({'bad': RUN.loaded_forbidden(), 'correct': line['correct'],\n"
            "                  'checks': line['checks'], 'attempted': line['attempted']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["attempted"] > 0
    assert got["correct"], got["checks"]


def test_the_reference_agrees_with_the_ports_plain_reference():
    """reference_unimoe's forward against tests/unimoe_reference.py on one
    tiny case (the int8 trees of weights_unimoe, no outlier columns, no
    dropout): the same selection of experts for every token, each W8A8
    product's law bit for bit, and the text positions' hidden states and
    loss within fp32's reordering (one routes the experts' rows together,
    the other row by row)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import unimoe_reference as PR
    cfg = TINY
    w = RU.WU.make_weights(cfg, SEED, "cpu")
    ad = RU.WU.make_adapters(cfg, 4, 8.0, SEED, "cpu")
    quant = RU.Quant(w, 0)
    quant.sets = {}
    mine = RU.Model(cfg, w, RF.Precision(), quant, ad, 0.0)
    enc_w = w["encoder"]["layers"]
    for name in ("q", "k", "v", "o"):        # the encoder's int8 base as the port holds it
        wq, ws = quant.q[id(enc_w["attn"][name]["w"])]
        enc_w["attn"][name] = dict(enc_w["attn"][name], w_q8=wq.to(torch.int8), w_scale=ws)
    for name in ("fc1", "fc2"):
        wq, ws = quant.q[id(enc_w["mlp"][name]["w"])]
        enc_w["mlp"][name] = dict(enc_w["mlp"][name], w_q8=wq.to(torch.int8), w_scale=ws)
    n = RU.WU.dims(cfg)
    theirs = PR.Reference(w, {"encoder_heads": 2, "encoder_layers": 2, "pool": 5,
                              "layers": 2, "head_dim": n["hd"], "heads": 4, "kv_heads": 2,
                              "eps": 1e-6, "rope_theta": 1e6, "top_k": 2, "top_p": 0.7,
                              "fixed": 2, "dynamic": 4}, ad)
    g = torch.Generator().manual_seed(3)
    mel = torch.randn((2, 200, 80), generator=g)
    tokens = torch.randint(0, 256, (2, 10), generator=g)
    labels = torch.randint(0, 256, (2, 10), generator=g)
    u = torch.randn((7, 64), generator=g)
    lp = RU._at(w["lm"]["layers"], 0)
    assert [[e for e, _ in t] for t in theirs.route(u, lp["router"]["w"])] == \
        _selection(mine, u, lp)
    p = RU._at(lp["dynamic"]["down"], 1)
    wq = p["w_q8_nk"].t()
    x = torch.randn((5, 48), generator=g)
    assert torch.equal(quant.kmajor(x, p, RF.Precision()), PR.w8a8(x, wq, p["w_scale"]))
    with torch.no_grad():
        h, want = mine.hidden(mel, tokens), theirs.hidden(mel, tokens)
        loss, want_loss = mine.loss(mel, tokens, labels), theirs.loss(mel, tokens, labels)
    assert float((h - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)


def _selection(model, u, lp):
    probs = torch.softmax(u @ lp["router"]["w"], dim=-1)
    p_sorted, idx = probs.sort(dim=-1, descending=True, stable=True)
    before = torch.cat([torch.zeros_like(p_sorted[:, :1]), p_sorted[:, :1]], dim=-1)
    return [[int(e) for e, t in zip(row, keep) if t]
            for row, keep in zip(idx[:, :2].tolist(), (before < 0.7).tolist())]


def test_the_control_fails_the_cells_limits(monkeypatch):
    """The reference one precision down (fp8 products, int4 W8A8) against
    the fp32 reference on the tiny cell: over at least one of its limits."""
    monkeypatch.setattr(FU, "PREFIX", (272,))
    monkeypatch.setattr(FU, "EOT", 273)
    line = RUN.control(tiny_cell(), [SEED], "lower", "cpu")[0]
    assert any(c["value"] > c["limit"] for c in line["checks"].values()), line


@pytest.mark.parametrize("change,error", [
    ({}, None),
    ({"hidden_size": 4096}, ValueError),                # heads of 146
    ({"num_key_value_heads": 5}, ValueError),           # not whole groups
    ({"dynamic_intermediate_size": 14336}, ValueError),
    ({"reduced": ["num_hidden_layers"]}, ValueError),
], ids=["published", "hidden", "kv_heads", "expert_width", "cut"])
def test_check_config_holds_the_published_shape(change, error):
    c = dict(_config(), **change)
    if error is None:
        FU.check_config(c)
    else:
        with pytest.raises(error):
            FU.check_config(c)


@pytest.mark.parametrize("change,matches", [
    ({}, True), ({"dynamic_intermediate_size": 14336}, False),
    ({"num_key_value_heads": 8}, False),
    ({"whisper_encoder": dict(_config()["whisper_encoder"], d_model=1024)}, False),
], ids=["published", "expert_width", "kv_heads", "encoder"])
def test_the_port_builds_the_file_as_stated(change, matches):
    assert FU.port_matches(dict(_config(), **change)) is matches


def test_the_cells_options_reach_the_reference():
    """The traffic's options, parsed by the program's parser, give the
    reference its settings and this model's prefix and end."""
    c = RUN.load_cell(CELL)
    opts = FU.reference_opts(T.parse_program_args(c, SEED, "cpu"), SEED)
    assert opts["int8"] and opts["calibrate"] and opts["encoder_adapters"]
    assert (opts["prefix"], opts["eot"]) == ((151644,), 151645)
    assert TR.make_pool(c["traffic"], SEED, 2).texts
