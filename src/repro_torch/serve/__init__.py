"""Serving (port of ``repro.serve``): the engine on packed QADAM weights
and the Pareto-front query server."""

from repro_torch.serve.engine import (PACK_MODES, Request, ServeEngine,
                                      dequantize_params, is_packed,
                                      pack_mode_of, packed_bytes,
                                      quantize_params)
from repro_torch.serve.frontserver import (DONE, EXPIRED, QUEUED, REJECTED,
                                           RUNNING, CacheEntry, FrontCache,
                                           FrontQuery, FrontResponse,
                                           FrontServer, backend_signature,
                                           budget_key)

__all__ = ["PACK_MODES", "Request", "ServeEngine", "dequantize_params",
           "is_packed", "pack_mode_of", "packed_bytes", "quantize_params",
           "DONE", "EXPIRED", "QUEUED", "REJECTED", "RUNNING", "CacheEntry",
           "FrontCache", "FrontQuery", "FrontResponse", "FrontServer",
           "backend_signature", "budget_key"]
