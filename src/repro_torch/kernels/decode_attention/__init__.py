from repro_torch.kernels.decode_attention.ops import decode_attention, split_plan
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    decode_attention_split_ref,
)

__all__ = ["decode_attention", "decode_attention_ref", "decode_attention_split_ref", "split_plan"]
