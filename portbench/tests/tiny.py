"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
port's test-nano model (d 64, 2 + 2 layers, 2 heads, byte vocabulary),
small batches and pools, the cell's own traffic laws, options and limits."""
import copy

from portbench import run as RUN

TINY = {"model_type": "test-nano", "d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
        "encoder_attention_heads": 2, "decoder_attention_heads": 2,
        "encoder_ffn_dim": 256, "decoder_ffn_dim": 256, "num_mel_bins": 80,
        "vocab_size": 272, "max_source_positions": 1500, "max_target_positions": 448}


def tiny_cell(name: str, batch: int = 4, pool: int = 12) -> dict:
    cell = copy.deepcopy(RUN.load_cell(name))
    cell["config"] = dict(TINY)
    tr = cell["traffic"]
    tr["batch"], tr["pool"], tr["audio_seconds"] = batch, pool, [2, 4]
    if "serve" in tr:
        tr["serve"]["max_length"] = 12
        tr["serve"]["check_utterances"] = 2
    return cell
