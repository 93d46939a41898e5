"""Serving on packed QADAM weights (port of ``repro.serve``; the front
server is not ported yet)."""

from repro_torch.serve.engine import (PACK_MODES, Request, ServeEngine,
                                      dequantize_params, is_packed,
                                      pack_mode_of, packed_bytes,
                                      quantize_params)

__all__ = ["PACK_MODES", "Request", "ServeEngine", "dequantize_params",
           "is_packed", "pack_mode_of", "packed_bytes", "quantize_params"]
