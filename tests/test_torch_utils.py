"""The port's copies of the JAX package's small modules against their
originals: utils/flops, and the five public functions the earlier slices
left out (normalize_batch, train_val_test_split, write_hdf5_dataset,
make_synthetic_dataset, num_adapter_params)."""
import jax
import numpy as np
import pytest
import torch

from asr_finetune_tpu.data import audiofolder as JA
from asr_finetune_tpu.data import hdf5 as JH
from asr_finetune_tpu.evaluation import normalize as JN
from asr_finetune_tpu.models.configs import WHISPER_CONFIGS as JCONFIGS
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu.utils import flops as jflops
from asr_finetune_tpu_torch.data import audiofolder as TA
from asr_finetune_tpu_torch.data import hdf5 as TH
from asr_finetune_tpu_torch.evaluation import normalize as TN
from asr_finetune_tpu_torch.models.configs import WHISPER_CONFIGS as TCONFIGS
from asr_finetune_tpu_torch.training import lora as TL
from asr_finetune_tpu_torch.utils import flops as tflops


@pytest.mark.parametrize("model", sorted(TCONFIGS))
def test_flops_equal_jax(model):
    """Every model's forward and train-step FLOPs, in both modes (and PEFT
    with the encoder frozen), equal the JAX package's counts."""
    t, j = TCONFIGS[model], JCONFIGS[model]
    for batch, label_len in ((1, 48), (4, 192), (16, 448)):
        assert tflops.encoder_flops(t, batch) == jflops.encoder_flops(j, batch)
        assert tflops.decoder_flops(t, batch, label_len) == \
            jflops.decoder_flops(j, batch, label_len)
        for mode in ("full", "peft"):
            for adapted in (True, False):
                assert tflops.train_step_flops(t, batch, label_len, mode,
                                               encoder_adapted=adapted) == \
                    jflops.train_step_flops(j, batch, label_len, mode,
                                            encoder_adapted=adapted)


def test_mfu_against_the_h100_peak():
    assert tflops.PEAK_TFLOPS == {"h100": 989.0}
    assert tflops.mfu(989e12, 1.0) == 1.0
    assert tflops.mfu(989e12, 2.0, n_chips=2) == 0.25
    with pytest.raises(KeyError):
        tflops.mfu(1.0, 1.0, chip="v5e")


def test_normalize_batch_equals_jax():
    texts = ["  Hallo, Welt!", "Wie geht's?", "JA; nein.", "", "Straße"]
    assert TN.normalize_batch(texts) == JN.normalize_batch(texts)
    assert TN.normalize_batch(iter(texts)) == [TN.normalize(t) for t in texts]


@pytest.mark.parametrize("n,seed,test,val", [(100, 1, 0.2, 0.1), (37, 5, 0.3, 0.25),
                                             (3, 0, 0.2, 0.1), (0, 2, 0.2, 0.1)])
def test_train_val_test_split_equals_jax(n, seed, test, val):
    ours = TA.train_val_test_split(n, seed, test, val)
    ref = JA.train_val_test_split(n, seed, test, val)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(ours).tolist()) == list(range(n))


def _rows(reader, n):
    return reader.read(range(n))


def test_write_hdf5_dataset_read_by_both_packages(tmp_path):
    """A file the port writes reads back through both packages' readers, and
    one the JAX package writes through the port's, row for row."""
    rng = np.random.default_rng(0)
    audios = [rng.standard_normal(int(n)).astype(np.float32) for n in (10, 16000, 3)]
    texts = ["der hund", "Großmutter erzählt über 1944", ""]
    TH.write_hdf5_dataset(str(tmp_path / "t.h5"), audios, texts)
    JH.write_hdf5_dataset(str(tmp_path / "j.h5"), audios, texts)
    readers = [TH.Hdf5AudioReader(str(tmp_path / "t.h5")),
               JH.Hdf5AudioReader(str(tmp_path / "t.h5")),
               TH.Hdf5AudioReader(str(tmp_path / "j.h5"))]
    for r in readers:
        got = _rows(r, 3)
        r.close()
        assert [i for i, _, _ in got] == [0, 1, 2]
        assert [t for _, _, t in got] == texts
        for (_, a, _), want in zip(got, audios):
            np.testing.assert_array_equal(a, want)
    with pytest.raises(ValueError):
        TH.write_hdf5_dataset(str(tmp_path / "x.h5"), audios, texts[:2])


def test_make_synthetic_dataset_equals_jax(tmp_path):
    TH.make_synthetic_dataset(str(tmp_path / "t.h5"), n=5, seed=3, min_sec=0.2, max_sec=0.6)
    JH.make_synthetic_dataset(str(tmp_path / "j.h5"), n=5, seed=3, min_sec=0.2, max_sec=0.6)
    t, j = TH.Hdf5AudioReader(str(tmp_path / "t.h5")), JH.Hdf5AudioReader(str(tmp_path / "j.h5"))
    assert len(t) == len(j) == 5
    for (ia, a, ta), (ib, b, tb) in zip(_rows(t, 5), _rows(j, 5)):
        assert (ia, ta) == (ib, tb)
        np.testing.assert_array_equal(a, b)
    t.close()
    j.close()


@pytest.mark.parametrize("model,rank,encoder", [("test-nano", 4, False),
                                                ("test-nano", 8, True), ("tiny", 8, True)])
def test_num_adapter_params_equals_jax(model, rank, encoder):
    ours = TL.init_adapters(torch.Generator().manual_seed(0), TCONFIGS[model],
                            TL.LoraConfig(rank=rank), encoder=encoder)
    ref = JL.init_adapters(jax.random.PRNGKey(0), JCONFIGS[model],
                           JL.LoraConfig(rank=rank), encoder=encoder)
    assert TL.num_adapter_params(ours) == JL.num_adapter_params(ref) > 0
