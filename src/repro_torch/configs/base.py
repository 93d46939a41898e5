"""Architecture configuration schema + registry (port of
``repro.configs.base``).

The port keeps its own copy of the ``ArchConfig`` schema, field for
field, and of every architecture config, so a config means the same
thing in both packages.  ``get(name)`` loads one by CLI id or module
name and ``reduced(name)`` its small same-family config for the CPU
tests.  The workload IR (``core.workloads.llm_decode`` / ``llm_moe``)
reads every config; the model stack serves the dense all-global ones
(``models.transformer.check_supported``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # lm | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention variants
    qk_norm: bool = False
    window: int = 0                      # sliding-window width (local layers)
    layer_pattern: str = "all_global"    # all_global | alt_local_global | gemma3
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    query_scale: float = 0.0             # 0 -> 1/sqrt(head_dim)

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0
    moe_shared: int = 0                  # number of shared experts
    first_dense: int = 0                 # leading dense layers (deepseek)
    dense_d_ff: int = 0                  # d_ff of those dense layers
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    shared_attn_every: int = 0           # zamba2: shared block period
    n_shared_blocks: int = 0             # zamba2: alternating shared blocks

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0

    # numerics
    act: str = "silu"
    tie_embeddings: bool = False
    zero_centered_norm: bool = False     # gemma (1 + g) RMSNorm
    embed_scale: bool = False            # gemma sqrt(d) embedding scaling
    pe_type: str = "fp32"                # QADAM PE type -> QAT numerics
    dtype: str = "bfloat16"              # compute dtype
    vocab_pad_to: int = 128

    # applicability notes
    sub_quadratic: bool = False          # eligible for long_500k
    has_decode: bool = True

    # perf-variant knobs of the JAX package (defaults = baseline); the
    # port runs the baseline and refuses the others
    mixed_precision: bool = False
    kv_replicate_to: int = 0
    attn_block_local: bool = False
    moe_ep_shard_map: bool = False
    moe_ep_int8_payload: bool = False
    attn_flash: bool = False

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad_to)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ASSIGNED = (
    "qwen3_32b", "gemma3_1b", "gemma2_9b", "smollm_135m", "phi35_moe",
    "deepseek_moe_16b", "rwkv6_1b6", "qwen2_vl_72b", "whisper_medium",
    "zamba2_7b",
)

# canonical CLI ids (--arch <id>) -> module names
ARCH_IDS = {
    "qwen3-32b": "qwen3_32b",
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "smollm-135m": "smollm_135m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-medium": "whisper_medium",
    "zamba2-7b": "zamba2_7b",
}


def _module(name: str):
    mod_name = ARCH_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS.values():
        raise ValueError(f"the port has no config {name!r}; it has "
                         f"{sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str) -> ArchConfig:
    """Load an ArchConfig by CLI id or module name."""
    return _module(name).ARCH


def reduced(name: str) -> ArchConfig:
    """Small same-family config for CPU tests."""
    return _module(name).reduced()


def list_archs():
    return list(ARCH_IDS)
