"""repro_torch.models — the LM substrate of the port.

Composable decoder blocks (GQA attention with local/global windows, logit
softcaps, qk-norm, partial rotary; MoE feed-forward; Mamba-1 SSM;
cross-attention) assembled from a
:class:`~repro_torch.models.config.ModelConfig` layer pattern, with the
same parameter and cache trees as ``repro.models``. Attention runs
through the hand-written kernels (``repro_torch.kernels.flash_attention``
for prefill, ``repro_torch.kernels.decode_attention`` for one-token
decode); ``layers.chunked_attention`` is the plain version.
``model_lib`` (``repro_torch.models.model``) is imported on first use.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import BlockSpec, ModelConfig

__all__ = ["ModelConfig", "BlockSpec", "model_lib"]


def __getattr__(name: str):
    if name == "model_lib":
        return importlib.import_module(f"{__name__}.model")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
