"""repro_torch.serve — SLO-aware LM serving on the card.

Two layers, one request type, as in ``repro.serve``:

* :class:`ServeEngine` is the port of ``repro.serve.engine``: a batched KV
  cache, prefill and decode steps through the attention kernels, and an
  admission rule from :data:`SERVE_POLICIES`;
* :class:`ServingGateway` is a copy of ``repro.serve.gateway``: it maps
  each :class:`RequestSpec` to a pipeline instance, runs admission, load
  shedding and preemption through the online driver on the host, and
  replays its plan into a :class:`ServeEngine`
  (:meth:`ServingGateway.serve`).
"""

from repro_torch.serve.engine import (
    SERVE_POLICIES,
    EngineConfig,
    Request,
    RequestSpec,
    ServeEngine,
)
from repro_torch.serve.gateway import (
    GatewayConfig,
    GatewayReport,
    ServingGateway,
    serve_cost_model,
    serve_pool,
    synth_requests,
    token_work_rates,
)
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step

__all__ = [
    "EngineConfig",
    "Request",
    "RequestSpec",
    "SERVE_POLICIES",
    "ServeEngine",
    "GatewayConfig",
    "GatewayReport",
    "ServingGateway",
    "serve_cost_model",
    "serve_pool",
    "synth_requests",
    "token_work_rates",
    "build_decode_step",
    "build_prefill_step",
]
