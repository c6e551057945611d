from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

__all__ = ["kmeans_assign", "kmeans_assign_ref"]
