"""Process meshes and data parallelism over ``torch.distributed``."""
