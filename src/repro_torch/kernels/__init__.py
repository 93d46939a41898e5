"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``)."""
