from repro_torch.kernels.window_agg.ops import window_agg
from repro_torch.kernels.window_agg.ref import window_agg_ref

__all__ = ["window_agg", "window_agg_ref"]
