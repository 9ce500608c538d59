"""The port's deployment CLIs against the JAX package on the CPU:
`cli.export` of a port checkpoint (AdaLoRA adapters over an int8 base,
carried from JAX trees) writes the leaves and values of the JAX
merge_adapters on the same trees, without the port-only K-major copies,
in the native format both packages load, and the JAX forward on it equals
the port's; `cli.prepare_model --verify` converts an HF directory as the
JAX CLI does; `models/native_io.save_params` round-trips both ways."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.cli import prepare_model as jax_prepare
from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu_torch import config as TC
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import export as export_cli
from asr_finetune_tpu_torch.cli import prepare_model
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.training import optim as TO
from asr_finetune_tpu_torch.training.checkpoint import (CheckpointManager,
                                                        save_trial_manifest)
from asr_finetune_tpu_torch.training.train_step import make_train_state

# tests/test_torch_peft.py's SMALL: 64-dim heads, 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
RANK = 4


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """The JAX model's fp32 parameters written as a native checkpoint (the
    port builds its base from it), AdaLoRA adapters with b moved off zero,
    and a rank mask that prunes some triplets."""
    jcfg = JConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    model_dir = str(tmp_path_factory.mktemp("jax_model"))
    JIO.save_params(model_dir, jparams, jcfg)
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg,
                           JL.LoraConfig(rank=RANK, alpha=8.0, adalora=True), encoder=True)
    rng = np.random.default_rng(9)
    jad = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.02 * rng.standard_normal(a.shape), jnp.float32)
        if p[-1].key in ("b", "e") else a, jad)
    jmask = jax.tree.map(
        lambda e: jnp.asarray((rng.uniform(size=e.shape) > 0.3).astype(np.float32)),
        JL.init_rank_mask(jad))
    return jcfg, jparams, model_dir, jad, jmask


def _argv(model_dir, *extra):
    return ["--model_path", model_dir, "--device", "cpu", "--peft", "--load_in_8bit",
            "--adalora", "--lora_rank", str(RANK), "--lora_alpha", "8", *extra]


def _port_checkpoint(ckpt_dir, args, jad, jmask):
    """A port checkpoint (adapter-only, as cli.train --peft writes it) of
    the JAX adapters and rank mask at step 2, scored, beside a worse one at
    step 4 that holds other adapters: the export takes the best."""
    built = run_lib.build_model(args, train=True)
    opt = TO.make_optimizer(1e-4, 4, trainable_mask=TO.adapter_freeze_mask(
        built.adapters, True))
    state = make_train_state(built.params, opt, built.adapters, adalora=True)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2, metric="eval_loss_wer",
                            adapter_only=True)
    carried = {"adapters": TIO.params_from_numpy(JIO._flatten(jad), "cpu"),
               "rank_mask": TIO.params_from_numpy(JIO._flatten(jmask), "cpu")}
    with torch.no_grad():
        for t, tree in carried.items():
            for (k, p), (k2, v) in zip(TO.leaves(state[t]), TO.leaves(tree)):
                assert k == k2
                p.copy_(v)
        state["step"] = 2
        mgr.save(2, state, {"eval_loss_wer": 1.0})
        for _, p in TO.leaves(state["adapters"]):
            p.mul_(3.0)
        state["step"] = 4
        mgr.save(4, state, {"eval_loss_wer": 2.0})


@pytest.mark.parametrize("int8_matmul", [True, False])
def test_export_equals_the_jax_merge(jax_trees, tmp_path, int8_matmul):
    """`cli.export` of the port checkpoint (--int8_matmul builds the
    K-major copies beside the int8 base; the export leaves them out): the
    same leaves as the JAX merge_adapters over the JAX int8 base and the
    rank-masked adapters, fp32 within 1e-6, int8 bit-equal; --adapter_path
    writes the masked adapters; the export loads in the JAX package, and
    its JAX forward equals the port's forward on it within 1e-4."""
    jcfg, jparams, model_dir, jad, jmask = jax_trees
    extra = ("--int8_matmul",) if int8_matmul else ()
    ckpt = str(tmp_path / "run" / "checkpoints")
    _port_checkpoint(ckpt, TC.parse_args(_argv(model_dir, *extra)), jad, jmask)
    out, adp = str(tmp_path / "export"), str(tmp_path / "adapters.npz")
    export_cli.main(["--checkpoint_dir", ckpt, "--export_dir", out,
                     "--adapter_path", adp, *_argv(model_dir, *extra)])

    masked = JL.apply_rank_mask(jad, jmask)
    ref = {k: np.asarray(v) for k, v in JIO._flatten(
        JL.merge_adapters(JQ.quantize_tree_int8(jparams), masked)).items()}
    with np.load(os.path.join(out, "params.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref)
    assert not any(TQ.KMAJOR_KEY in k for k in got)
    for k, v in ref.items():
        assert got[k].dtype == (np.int8 if v.dtype == np.int8 else np.float32), k
        if v.dtype == np.int8:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert got["decoder/layers/self_attn/q/w"].dtype == np.float32     # merged
    assert got["decoder/layers/self_attn/k/w_q8"].dtype == np.int8      # kept int8
    with np.load(adp) as z:
        for k, v in JIO._flatten(masked).items():
            np.testing.assert_allclose(z[k], np.asarray(v), rtol=0, atol=0, err_msg=k)

    jload, jcfg2 = JIO.load_params(out)
    assert jcfg2 == jcfg
    tload, _ = TIO.load_params(out, "cpu")
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 300, SMALL["num_mel_bins"])).astype(np.float32)
    toks = rng.integers(0, 289, (2, 6)).astype(np.int32)
    want = jax.jit(lambda p, m, t: JW.forward(p, m, t, jcfg, compute_dtype=jnp.float32,
                                              decoder_attn_impl="xla"))(
        jload, jnp.asarray(mel), jnp.asarray(toks))
    ours = TW.forward(tload, torch.from_numpy(mel), torch.from_numpy(toks).long(),
                      TConfig(**SMALL), torch.float32, decoder_attn_impl="xla")
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_export_reads_the_trial_hp_and_steps(jax_trees, tmp_path):
    """An HPO trial's checkpoints: the adapters are built at the rank its
    trial_manifest.json names (here 4, where the flags say 8);
    --checkpoint_step picks a step; --no-merge_adapters keeps the int8
    base as it is."""
    _, jparams, model_dir, jad, jmask = jax_trees
    ckpt = str(tmp_path / "trial_0000" / "checkpoints")
    _port_checkpoint(ckpt, TC.parse_args(_argv(model_dir)), jad, jmask)
    save_trial_manifest(str(tmp_path / "trial_0000"), {"hp": {"rank": RANK}})
    argv = _argv(model_dir)
    argv[argv.index("--lora_rank") + 1] = "8"
    out, adp = str(tmp_path / "export"), str(tmp_path / "adapters.npz")
    export_cli.main(["--checkpoint_dir", ckpt, "--export_dir", out, "--checkpoint_step",
                     "4", "--adapter_path", adp, "--no-merge_adapters", *argv])
    with np.load(adp) as z:
        np.testing.assert_allclose(
            z["decoder/self_attn/q/b"],
            3.0 * np.asarray(JL.apply_rank_mask(jad, jmask)["decoder"]["self_attn"]["q"]["b"]),
            rtol=1e-6, atol=0)
    ref = {k: np.asarray(v) for k, v in JIO._flatten(JQ.quantize_tree_int8(jparams)).items()}
    with np.load(os.path.join(out, "params.npz")) as z:
        assert sorted(z.files) == sorted(ref)
        np.testing.assert_array_equal(z["encoder/layers/attn/q/w_q8"],
                                      ref["encoder/layers/attn/q/w_q8"])


def test_serving_build_keeps_a_merged_int8_base(jax_trees, tmp_path):
    """run.build_model for serving (cli.transcribe, --bf16 on by default)
    over a merged, mixed export: the float weights become bf16, the int8
    weights stay int8 with fp32 scales (the decoder kernels' mixed-weight
    route reads them so), and the bf16 encoder output is bit-equal to the
    one over the weights as loaded."""
    jcfg, jparams, _, jad, jmask = jax_trees
    out = str(tmp_path / "merged")
    JIO.save_params(out, JL.merge_adapters(JQ.quantize_tree_int8(jparams),
                                           JL.apply_rank_mask(jad, jmask)), jcfg)
    built = run_lib.build_model(TC.parse_args(["--model_path", out, "--device", "cpu"]))
    attn = built.params["decoder"]["layers"]["self_attn"]
    assert attn["q"]["w"].dtype == torch.bfloat16
    assert attn["k"]["w_q8"].dtype == torch.int8 and attn["k"]["w_scale"].dtype == torch.float32
    assert built.params["decoder"]["layers"]["mlp"]["fc1"]["w_q8"].dtype == torch.int8
    loaded, _ = TIO.load_params(out, "cpu")
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 300, SMALL["num_mel_bins"])).astype(np.float32))
    assert torch.equal(TW.encode(built.params, mel, built.cfg, torch.bfloat16),
                       TW.encode(loaded, mel, built.cfg, torch.bfloat16))


def test_save_params_round_trips_with_jax(tmp_path):
    """The port's save_params writes what the JAX load_params reads, and
    the reverse: the same leaves, values and config, and the same format
    string."""
    cfg = TConfig(**SMALL)
    params = TQ.quantize_tree_int8(TW.init_params(cfg, seed=1))
    TIO.save_params(str(tmp_path / "port"), params, cfg)
    jparams, jcfg = JIO.load_params(str(tmp_path / "port"))
    assert jcfg == JConfig(**SMALL)
    flat = TIO.params_to_numpy(params)
    assert sorted(JIO._flatten(jparams)) == sorted(flat)
    for k, v in JIO._flatten(jparams).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    JIO.save_params(str(tmp_path / "jax"), jparams, jcfg)
    back, cfg2 = TIO.load_params(str(tmp_path / "jax"), "cpu")
    assert cfg2 == cfg
    for k, v in TIO.params_to_numpy(back).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    with open(tmp_path / "port" / "config.json") as f, \
            open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random HF Whisper checkpoint written by save_pretrained, as
    tests/test_native_io.py makes one."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    d = tmp_path_factory.mktemp("hf")
    hf_cfg = WhisperConfig(
        vocab_size=300, num_mel_bins=80, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=150,
        max_target_positions=64, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=3)
    torch.manual_seed(0)
    WhisperForConditionalGeneration(hf_cfg).save_pretrained(str(d))
    return str(d)


def test_prepare_model_verify_matches_jax(hf_dir, tmp_path, capsys):
    """`prepare_model --verify --device cpu` converts the HF directory to
    the npz and config the JAX CLI writes, and its forward passes."""
    prepare_model.main(["--hf_dir", hf_dir, "--output", str(tmp_path / "port"),
                        "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "verify OK" in out
    summary = json.loads(out.strip().splitlines()[-1])
    jax_prepare.main(["--hf_dir", hf_dir, "--output", str(tmp_path / "jax")])
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files) and summary["leaves"] == len(a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "port" / "config.json") as f, \
            open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)


def test_deployment_clis_without_device_cpu_raise(hf_dir, jax_trees, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_model.main(["--hf_dir", hf_dir, "--output", str(tmp_path / "p")])
    argv = _argv(jax_trees[2])
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--checkpoint_dir", str(tmp_path / "c"), "--export_dir",
                         str(tmp_path / "e"), *argv])
