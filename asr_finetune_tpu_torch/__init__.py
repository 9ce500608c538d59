"""PyTorch + CUDA port of the asr_finetune_tpu serving path (NVIDIA Hopper).

The JAX package (asr_finetune_tpu/) is the reference this port is tested
against; nothing here imports it or JAX. Module names mirror the JAX
package's so each function has an obvious counterpart. Every Pallas kernel
on the ported path is a hand-written CUDA C++ kernel for sm_90a under
csrc/, built at first use by ops/_build.py; each wrapper keeps a plain
PyTorch version beside it, which it runs only for CPU tensors.

Ported so far (the greedy transcription slice): log-mel, the Whisper
encoder with the encoder-attention kernel, greedy decode through the fused
per-token decoder kernels (fused_qkv, fused_attn self + cross, fused_mlp),
and `python -m asr_finetune_tpu_torch.cli.transcribe`.
"""
