from repro_torch.kernels.quant_matmul.quant_matmul import (
    GEMV_LOADS, GEMV_THREADS, alignment, launch_plan, plan, plan_ranges,
    quant_matmul, quant_matmul_any)
