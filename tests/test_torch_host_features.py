"""Host features in the port against the JAX package: the float64 host
log-mel (ops/logmel.log_mel_np), the parquet feature shards
(data/parquet.py) written and read by either package, `cli.materialize`,
the int8 outlier calibration on a batch of host features, and the port's
imports on a machine without pyarrow. The CLI runs of --host_logmel and
the parquet data modes: tests/test_torch_train_cli.py
::test_options_not_ported_raise."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from asr_finetune_tpu.cli import materialize as JMAT
from asr_finetune_tpu.data import parquet as JPQ
from asr_finetune_tpu.data.hdf5 import Hdf5AudioReader as JH5, make_synthetic_dataset
from asr_finetune_tpu.models import tokenizer as JT
from asr_finetune_tpu.ops import logmel as JL
from asr_finetune_tpu_torch import config as config_lib
from asr_finetune_tpu_torch import run as run_lib
from asr_finetune_tpu_torch.cli import materialize as TMAT
from asr_finetune_tpu_torch.data import parquet as TPQ
from asr_finetune_tpu_torch.data.hdf5 import Hdf5AudioReader as TH5
from asr_finetune_tpu_torch.models import tokenizer as TT
from asr_finetune_tpu_torch.ops import logmel as TL

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5")
    make_synthetic_dataset(str(d / "test.h5"), n=8, seed=3, min_sec=0.5, max_sec=2.0)
    return str(d / "test.h5")


@pytest.mark.parametrize("n_mels,seconds", [(80, 1.3), (128, 31.0)])
def test_log_mel_np_is_the_jax_function_bit_for_bit(n_mels, seconds):
    rng = np.random.default_rng(n_mels)
    audio = TL.pad_or_trim((rng.standard_normal(int(16000 * seconds)) * 0.1)
                           .astype(np.float32))
    ours, ref = TL.log_mel_np(audio, n_mels), JL.log_mel_np(audio, n_mels)
    assert ours.dtype == np.float32 and ours.shape == (3000, n_mels)
    np.testing.assert_array_equal(ours, ref)


def _read_all(reader):
    return reader.read_features(list(range(len(reader))))


def test_shards_cross_read_between_the_packages(h5, tmp_path):
    """The port's shards read by the JAX reader and the JAX shards by the
    port's equal each other and the writer's own reading, array for array;
    the ParquetCollator batches and the length-grouping keys agree too."""
    made = {}
    for name, mod, reader, tok in (("port", TPQ, TH5, TT), ("jax", JPQ, JH5, JT)):
        r = reader(h5)
        files = mod.materialize_hdf5_to_parquet(r, tok.load_tokenizer(),
                                                str(tmp_path / name), n_mels=80,
                                                shard_size=3)
        assert [os.path.basename(f) for f in files] == [
            "shard-00000000.parquet", "shard-00000003.parquet", "shard-00000006.parquet"]
        made[name] = str(tmp_path / name)
    ref = _read_all(JPQ.ParquetFeatureReader(made["jax"]))
    assert ref["mel"].shape == (8, 3000, 80) and ref["labels"].shape == (8, 448)
    for d in made.values():
        for reader in (TPQ.ParquetFeatureReader(d), JPQ.ParquetFeatureReader(d)):
            got = _read_all(reader)
            for k in ("mel", "labels"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{d} {k}")
            assert list(got["text"]) == list(ref["text"])
            np.testing.assert_array_equal(reader.transcript_lengths(),
                                          JPQ.ParquetFeatureReader(d).transcript_lengths())
    sp = TT.load_tokenizer().special
    tr = TPQ.ParquetFeatureReader(made["port"])
    jr = JPQ.ParquetFeatureReader(made["jax"])
    idx = np.array([5, 0, 7])
    ours = TPQ.ParquetCollator(tr, sp.sot, sp.pad)(idx)
    theirs = JPQ.ParquetCollator(jr, sp.sot, sp.pad)(idx)
    assert sorted(ours) == sorted(theirs)
    for k in ("mel", "labels", "decoder_input_ids", "idx"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("num_procs", [1, 2])
def test_cli_materialize_matches_jax(h5, tmp_path, capsys, num_procs):
    """`cli.materialize` (one process, or two by spawn) writes the shards
    the JAX CLI writes in one process: the same rows in the same order
    (tests/test_cli_eval.py::test_cli_materialize is the JAX model)."""
    JMAT.main(["--dataset_name", h5, "--materialize_output", str(tmp_path / "jax"),
               "--n_mels", "80", "--shard_size", "4"])
    capsys.readouterr()
    out = TMAT.main(["--dataset_name", h5, "--materialize_output", str(tmp_path / "port"),
                     "--n_mels", "80", "--shard_size", "4",
                     "--num_procs", str(num_procs)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["rows"] == 8 and out["files"] == 2
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    ours = _read_all(TPQ.ParquetFeatureReader(str(tmp_path / "port")))
    ref = _read_all(JPQ.ParquetFeatureReader(str(tmp_path / "jax")))
    for k in ("mel", "labels"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert list(ours["text"]) == list(ref["text"])


def test_imports_without_pyarrow_and_parquet_names_it():
    """The card's machine has no pyarrow: the port's training and
    materialize entry points still import, and a parquet reader or
    materialization raises ImportError naming pyarrow, with no fallback."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pyarrow"] = None              # any `import pyarrow` now raises
        sys.modules["pyarrow.parquet"] = None
        import asr_finetune_tpu_torch.run, asr_finetune_tpu_torch.cli.train
        import asr_finetune_tpu_torch.cli.materialize
        from asr_finetune_tpu_torch.data import parquet
        for call in (lambda: parquet.ParquetFeatureReader("x"),
                     lambda: parquet.materialize_hdf5_to_parquet(None, None, "x")):
            try:
                call()
            except ImportError as e:
                assert "pyarrow" in str(e), e
            else:
                raise AssertionError("no ImportError")
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def _peft_host_argv(h5, out):
    return ["--model_type", "test-nano", "--device", "cpu", "--data_mode", "h5",
            "--dataset_name", h5, "--val_split", "0.5",
            "--per_device_train_batch_size", "1", "--per_device_eval_batch_size", "4",
            "--max_steps", "1", "--eval_steps", "1", "--save_steps", "1",
            "--generation_max_length", "4", "--output_dir", str(out),
            "--peft", "--load_in_8bit", "--int8_matmul", "--host_logmel"]


def test_calibration_runs_on_host_features_where_jax_raises(h5, tmp_path, monkeypatch):
    """With --host_logmel under --int8_matmul the outlier calibration's
    batch carries "mel" and no "audio": the port keeps "mel" and
    calibrates every W8A8 class; the JAX filter keeps "audio" and
    "input_features" only, so its forward raises KeyError (a standing
    divergence, ROADMAP.md §3)."""
    from asr_finetune_tpu_torch.data import pipeline as TPIPE
    seen = []
    real = TPIPE.to_device

    def to_device(batch, *a, **k):
        seen.append(sorted(batch))
        return real(batch, *a, **k)

    monkeypatch.setattr(TPIPE, "to_device", to_device)
    args = config_lib.parse_args(_peft_host_argv(h5, tmp_path / "port"))
    trainer = run_lib.setup_trial(args)
    try:
        idx = trainer.step_cfg.quant.static_idx
    finally:
        trainer.metrics.close()
    assert seen[0] == ["decoder_input_ids", "labels", "mel"]
    assert trainer.step_cfg.on_device_logmel is False
    d, ff = 64, 256                               # test-nano
    assert set(idx) == {(d, d), (d, ff), (ff, d)}

    from asr_finetune_tpu import config as jconfig
    from asr_finetune_tpu import run as jrun
    jargs = jconfig.parse_args(_peft_host_argv(h5, tmp_path / "jax")[4:] + [
        "--model_type", "test-nano"])
    with pytest.raises(KeyError, match="mel"):
        jrun.run_trial(jargs)
