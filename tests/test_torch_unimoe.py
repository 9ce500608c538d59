"""Uni-MoE-2.0-Omni's speech-to-text path (models/unimoe.py) against the plain
fp32 reference (tests/unimoe_reference.py), which imports neither JAX nor
the port, at the tiny test-unimoe config on the CPU: d 64, 2 LM layers of 4
query and 2 KV heads, 2 fixed, 4 dynamic and 1 null expert (top-p 0.7, at
most 2), a byte vocabulary, test-nano's 2-layer encoder, 200 log-mel frames
(100 encoder frames, 20 audio tokens) and 12 text tokens.

Both sides compute in fp32, so they part only by the order of their sums
(the port's fused cross-entropy, its batched expert rows, the reference's
row by row): 1e-4 relative to each tensor's largest value, ~1,000 ulps of
fp32, far under what a wrong term (a dropped expert, a missed rotation, a
mask off by one) moves. The int8 base holds the same laws: each of its W8A8
products equals the reference's law bit for bit, and the loss is held to
1e-3 (a value one ulp apart upstream can round to the next int8 step). The
routing is held to hand-worked cases, and the
plain W8A8 at K 18,944 (past the kernel's 8,192-register quantize pass) to
the reference's law bit for bit."""
import pytest
import torch

from asr_finetune_tpu_torch.models import unimoe as U
from asr_finetune_tpu_torch.models.configs import get_config
from asr_finetune_tpu_torch.ops import quant as Q
from asr_finetune_tpu_torch.ops import w8a8_fused as WF
from asr_finetune_tpu_torch.ops.fused_ce import fused_cross_entropy
from asr_finetune_tpu_torch.training import lora
from unimoe_reference import Reference, w8a8  # tests/, on sys.path under pytest

CFG = get_config("test-unimoe")
B, FRAMES, T = 2, 200, 12


def _ref_cfg(cfg=CFG):
    return {"encoder_heads": cfg.encoder.encoder_heads, "encoder_layers": cfg.encoder.encoder_layers,
            "pool": cfg.audio_pool, "layers": cfg.num_hidden_layers, "head_dim": cfg.head_dim,
            "heads": cfg.num_attention_heads, "kv_heads": cfg.num_key_value_heads,
            "eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "top_k": cfg.mlp_dynamic_top_k, "top_p": cfg.mlp_dynamic_top_p,
            "fixed": cfg.mlp_fixed_expert_num, "dynamic": cfg.mlp_dynamic_expert_num}


def _model(int8: bool, seed: int = 5):
    """Seeded weights (the int8 ones the quantized float ones, both layouts
    for the encoder, the LM's K-major alone), adapters whose b is drawn too
    (so the deltas are in the forward), inputs and labels."""
    params = U.init_params(CFG, seed=seed, int8=int8)
    # the gate drawn wider, so that some tokens take one expert and some two
    params["lm"]["layers"]["router"]["w"].mul_(40.0)
    if int8:
        params = Q.add_k_major_copies(Q.quantize_tree_int8(params))
        params["lm"]["embed"] = params["lm"]["embed"].float()
        params["lm"]["head"] = params["lm"]["head"].float()
    g = torch.Generator().manual_seed(seed)
    ad = lora.init_adapters(g, CFG, lora.LoraConfig(rank=4, alpha=8.0), encoder=True)
    for _, stack in lora._adapter_stacks(ad):
        stack["b"].normal_(0.0, 0.05, generator=g)
    mel = torch.randn((B, FRAMES, CFG.num_mel_bins), generator=g)
    tokens = torch.randint(0, 256, (B, T), generator=g)
    labels = torch.cat([tokens[:, 1:], torch.full((B, 1), CFG.eos_token_id)], 1)
    labels[1, 8:] = -100                            # a shorter transcript, padded
    return params, ad, mel, tokens, labels


def _close(got, want, rtol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


def _port_loss(params, ad, mel, tokens, labels, quant=None, remat=False):
    h = U.forward(params, mel, tokens, CFG, torch.float32, remat=remat, adapters=ad,
                  quant=quant)
    loss, _ = fused_cross_entropy(h, params["lm"]["head"], labels, embed_grad=False)
    return h, loss


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_forward_and_loss_match_the_reference(monkeypatch, int8):
    """The text positions' hidden states and the loss. The int8 base takes
    the outlier sets its own calibration installs (threshold 2: every class,
    the expert products' included, holds some) on both sides; every one of
    its W8A8 products, the experts', the projector's and the encoder's,
    equals the reference's law on the same input bit for bit, and the loss
    agrees within 1e-3: an upstream value one ulp apart can round to the
    next int8 step and move what follows (on seed 5 the hidden states part
    by 1.5% at one token whose selection turns, the loss by 4e-5)."""
    params, ad, mel, tokens, labels = _model(int8)
    quant = sets = None
    if int8:
        quant = Q.QuantConfig(matmul=True, outlier_cols=2)
        sets = Q.calibrate_int8_outliers(lambda: _port_loss(params, ad, mel, tokens, labels,
                                                            quant),
                                         quant, threshold=2.0, max_cols=4)
        d, Fs, Fd = CFG.hidden_size, CFG.shared_intermediate_size, CFG.dynamic_intermediate_size
        classes = {(d, Fs), (Fs, d), (d, Fd), (Fd, d), (CFG.whisper_hidden_size, d)}
        assert classes <= set(sets) and any(sets.values())
        seen, product = set(), Q.int8_matmul

        def checked(x, w_q8, w_scale, cfg, w_nk=None, row_split=False):
            y = product(x, w_q8, w_scale, cfg, w_nk, row_split)
            klass = tuple(w_q8.shape)
            seen.add(klass)
            law = w8a8(x.reshape(-1, klass[0]), w_q8, w_scale, sets.get(klass))
            assert torch.equal(y, law.reshape(y.shape)), klass
            return y
        monkeypatch.setattr(Q, "int8_matmul", checked)
    with torch.no_grad():
        h, loss = _port_loss(params, ad, mel, tokens, labels, quant)
        ref = Reference(params, _ref_cfg(), ad, sets)
        want_h, want_loss = ref.hidden(mel, tokens), ref.loss(mel, tokens, labels)
    if int8:
        assert classes <= seen
        assert abs(float(loss) - float(want_loss)) <= 1e-3 * abs(float(want_loss))
    else:
        _close(h, want_h, 1e-4)
        assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_adapter_gradients_match_the_reference(remat):
    """Every adapter leaf's gradient (encoder and LM q/v: a, e, b), through
    the routing's probabilities with the selection held; remat recomputes
    each layer in the backward and gives the same."""
    params, ad, mel, tokens, labels = _model(False, seed=7)
    trained = [(k, p) for k, p in lora.leaves(ad) if not k.endswith("scaling")]
    for _, p in trained:
        p.requires_grad_(True)
    _, loss = _port_loss(params, ad, mel, tokens, labels, remat=remat)
    got = torch.autograd.grad(loss, [p for _, p in trained])
    want = torch.autograd.grad(Reference(params, _ref_cfg(), ad).loss(mel, tokens, labels),
                               [p for _, p in trained])
    for (k, _), g, w in zip(trained, got, want):
        assert float(w.abs().max()) > 0, k
        _close(g, w, 1e-4)


def _hand_layer(probs):
    """Layer 0 of the tiny LM with a gate that gives the one input row, a
    unit vector, exactly the probabilities `probs` (their logs as the
    router's first row)."""
    lp = _first(U.init_params(CFG, seed=11)["lm"]["layers"])
    w = torch.zeros((CFG.hidden_size, len(probs)))
    w[0] = torch.log(torch.tensor(probs))
    lp["router"] = {"w": w}
    u = torch.zeros((1, 1, CFG.hidden_size))
    u[0, 0, 0] = 1.0
    return lp, u


def _first(tree):
    return {k: _first(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


# each row's probabilities over (dynamic 0-3, null 4), the kinds of its two
# slots (4: a null expert, 5: not taken) and its dynamic experts' weights
ROUTES = {
    "top one holds 0.7": ([0.8, 0.05, 0.05, 0.05, 0.05], [0, 5], {0: 0.8}),
    "just under 0.7 takes two": ([0.69, 0.2, 0.05, 0.03, 0.03], [0, 1], {0: 0.69, 1: 0.2}),
    "null second adds nothing": ([0.1, 0.5, 0.05, 0.05, 0.3], [1, 4], {1: 0.5}),
    "null first": ([0.05, 0.05, 0.35, 0.05, 0.5], [4, 2], {2: 0.35}),
    "two dynamic": ([0.4, 0.05, 0.45, 0.05, 0.05], [2, 0], {2: 0.45, 0: 0.4}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_hand_worked(case):
    """The selection (the shortest prefix of the sorted probabilities that
    reaches 0.7, at most 2; a null pick takes a slot and adds nothing), the
    layer's output (the fixed experts at 1, each dynamic one at its
    probability) and the counters the layer adds, one count sync a call."""
    probs, kinds, weights = ROUTES[case]
    cfg = CFG
    lp, u = _hand_layer(probs)
    p_k, kind = U.route(u[0], lp["router"]["w"], cfg)
    assert kind.tolist() == kinds
    assert torch.allclose(p_k[0], torch.tensor(sorted(probs, reverse=True)[:2]), atol=1e-6)
    before = U.moe_counters()
    out = U.moe(u, lp, cfg)
    moved = {k: v - before[k] for k, v in U.moe_counters().items()}
    want = sum(U.swiglu(u[0], U._expert(lp["fixed"], f), None)
               for f in range(cfg.mlp_fixed_expert_num))
    for e, pe in weights.items():
        want = want + pe * U.swiglu(u[0], U._expert(lp["dynamic"], e), None)
    _close(out[0], want, 1e-5)
    assert moved == {"layer_calls": 1, "tokens": 1, "slots": sum(k != 5 for k in kinds),
                     "null_slots": kinds.count(4), "expert_rows": len(weights),
                     "count_syncs": 1}


@pytest.mark.parametrize("K", [8208, 18944])
def test_int8_long_k_matches_the_law(K):
    """The plain W8A8 at K past 8,192 (the expert down-projection's 18,944)
    equals the reference's law bit for bit, with an outlier set; the
    product through a K-major-only weight (w_q8 the view of w_nk, as the
    LM holds it) gives the same, and its straight-through gradient is
    dy @ (w_nk · s)."""
    g = torch.Generator().manual_seed(K)
    x = torch.randn((6, K), generator=g)
    x[:, 3] *= 30.0
    w = torch.randn((K, 24), generator=g) / K ** 0.5
    part = Q.quantize_weight(w)
    wq, ws = part[Q.QUANT_KEY], part[Q.SCALE_KEY]
    idx = (3, 100)
    keep = torch.ones(K)
    keep[list(idx)] = 0.0
    addend = x[:, list(idx)] @ (wq[list(idx)].float() * ws.reshape(1, -1))
    got = WF.w8a8_plain(x, wq, ws, keep, addend)
    assert torch.equal(got, w8a8(x, wq, ws, idx))
    w_nk = wq.t().contiguous()
    xg = x.clone().requires_grad_(True)
    cfg = Q.QuantConfig(matmul=True, outlier_cols=2, static_idx={(K, 24): idx})
    y = Q.int8_matmul(xg, w_nk.t(), ws, cfg, w_nk)
    assert torch.equal(y, got)
    dy = torch.randn(y.shape, generator=g)
    (y * dy).sum().backward()
    _close(xg.grad, dy @ (w_nk.float() * ws.reshape(-1, 1)), 1e-6)


@pytest.mark.parametrize("argv,train,match", [
    (["--peft", "--load_in_8bit"], False, "no serving path"),
    ([], True, "PEFT over the int8 base only"),
    (["--peft"], True, "PEFT over the int8 base only"),
    (["--peft", "--load_in_8bit", "--tp", "2"], True, "--tp 1"),
], ids=["serve", "full", "peft-float", "tp2"])
def test_what_the_port_lacks_for_this_model_raises(argv, train, match):
    """run.build_model builds the model for PEFT over the int8 base alone;
    serving (greedy WER, cli.transcribe, cli.evaluate), the other training
    modes and tensor parallelism raise NotImplementedError naming what is
    missing, as does the decode the trainer holds for this model."""
    from asr_finetune_tpu_torch import config, run
    args = config.parse_args(["--device", "cpu", "--model_type", "test-unimoe"] + argv)
    with pytest.raises(NotImplementedError, match=match):
        run.build_model(args, train=train)
    with pytest.raises(NotImplementedError, match="no serving path"):
        U.no_decode()
