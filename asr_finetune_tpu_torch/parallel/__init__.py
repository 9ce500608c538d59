"""Data parallelism across processes for the port (counterpart of
asr_finetune_tpu/parallel/): one process per card in a torch.distributed
group (`mesh`), and the ZeRO partition and host offload of the training
state (`sharding`)."""
