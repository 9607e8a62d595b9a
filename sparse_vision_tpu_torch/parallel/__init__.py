"""Data- and tensor-parallel SAE training over a torch.distributed world (port
of sparse_vision_tpu/parallel/): one process per rank, the ranks arranged as
JAX's (data, model) device mesh."""
