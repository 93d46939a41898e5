from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_HEAD_DIMS, Plan, attention_backward, block_keys, block_rows,
    flash_attention, flash_attention_bh, flash_attention_gqa, plan)
from repro_torch.kernels.flash_attention.ref import soft_cap
