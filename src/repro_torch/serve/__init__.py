"""repro_torch.serve — continuous-batching LM serving on the card.

:class:`ServeEngine` is the port of ``repro.serve.engine``: a batched KV
cache, prefill and decode steps through the attention kernels, and an
admission rule from :data:`SERVE_POLICIES`. The SLO-aware gateway
(``repro.serve.gateway``) needs ``core/online``, which the port does not
have yet, so it is not exported here.
"""

from repro_torch.serve.engine import (
    SERVE_POLICIES,
    EngineConfig,
    Request,
    RequestSpec,
    ServeEngine,
)
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step

__all__ = [
    "EngineConfig",
    "Request",
    "RequestSpec",
    "SERVE_POLICIES",
    "ServeEngine",
    "build_decode_step",
    "build_prefill_step",
]
