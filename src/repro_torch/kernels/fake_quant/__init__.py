from repro_torch.kernels.fake_quant.fake_quant import (
    GROUP_MAX, Part, block_ranges, fake_quant, fake_quant_any,
    fake_quant_group, head, plan, span)
