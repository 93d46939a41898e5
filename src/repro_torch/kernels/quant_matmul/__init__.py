from repro_torch.kernels.quant_matmul.quant_matmul import (quant_matmul,
                                                          quant_matmul_any)
