from huggingface_asr_tpu_torch.parallel.distributed import host_barrier, initialize_distributed, is_primary
from huggingface_asr_tpu_torch.parallel.mesh import Mesh, MeshConfig

__all__ = ["Mesh", "MeshConfig", "initialize_distributed", "host_barrier", "is_primary"]
