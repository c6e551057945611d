"""repro_torch.models — the LM substrate of the serving path.

Dense decoder blocks (GQA attention with local/global windows, logit
softcaps, qk-norm, partial rotary) assembled from a
:class:`~repro_torch.models.config.ModelConfig` layer pattern, with the
same parameter and cache trees as ``repro.models``. Attention runs
through the hand-written kernels (``repro_torch.kernels.flash_attention``
for prefill, ``repro_torch.kernels.decode_attention`` for one-token
decode); ``layers.chunked_attention`` is the plain version.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

__all__ = ["ModelConfig", "BlockSpec"]
