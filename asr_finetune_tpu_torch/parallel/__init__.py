"""Data and tensor parallelism across processes for the port (counterpart
of asr_finetune_tpu/parallel/): one process per card in a
torch.distributed group laid out as data x tp (`mesh`), and the
tensor-parallel split of the model, the ZeRO partition and host offload of
the training state (`sharding`)."""
