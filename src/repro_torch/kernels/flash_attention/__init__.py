from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_bh, flash_attention_gqa)
