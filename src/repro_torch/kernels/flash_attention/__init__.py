from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_HEAD_DIMS, WGMMA_DIMS, BwdPlan, Plan, attention_backward, block_keys,
    block_rows, bwd_key_splits, bwd_packed_elems, bwd_wgmma_plan,
    flash_attention, flash_attention_bh, flash_attention_gqa,
    fwd_packed_elems, key_lanes, lane_columns, plan, wgmma_smem)
from repro_torch.kernels.flash_attention.ref import soft_cap
