"""Model configuration system + architecture registry.

One config file per assigned architecture lives next to this module; each
exposes ``CONFIG`` (the exact published dims) and ``SMOKE`` (a reduced
same-family variant for CPU tests) and registers itself.  The port's own
copy of ``repro.configs``: the same dims, value for value, with
``torch_dtype`` in place of ``jdtype``.  ``moe_impl`` and
``moe_dispatch`` (the expert-parallel MoE path) and ``remat_policy`` (the
training forward's per-layer recomputation) are kept with the
reference's defaults.  ``cache_shard`` and ``shard_logits`` are the
dry-run's two knobs (``launch/shapes.py``: how a decode cell's caches
and logits are partitioned), with the reference's defaults; no config
sets them.  The reference's ``scan_unroll`` is left out: it only makes
XLA's cost analysis see every layer of a scan, and the port's layers are
Python loops that the dry-run's counter sees one by one
(``launch/dryrun.py`` refuses ``--override scan_unroll=...`` and says
so).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # attention flavour
    attn_bias: bool = False           # qwen2: QKV bias
    parallel_block: bool = False      # command-r: parallel attn+FFN
    rope_theta: float = 10_000.0
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0             # 0 -> standard GQA
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0       # leading dense layers in MoE stacks
    moe_every: int = 1                # llama4: MoE every 2nd layer
    moe_impl: str = "gshard"          # gshard | dispatch (paper routed a2a)
    moe_dispatch: str = "direct"      # direct | grid (Section VI-A schedule)
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    shared_attn_every: int = 0        # zamba2: shared attn block period
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub
    frontend: str = "none"            # none | patch | audio
    frontend_len: int = 0             # patches / frames occupying the prefix
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_impl: str = "naive"          # naive | blockwise (flash-style
    # online softmax over KV chunks; §Perf optimization)
    attn_block: int = 512             # KV chunk for blockwise attention
    remat_policy: str = "none"        # none | dots: what a layer's
    # recomputation keeps in the training forward (models/model.py)
    cache_shard: str = "feature"      # feature | sequence: a decode
    # cell's cache partitioning over the model axis (launch/shapes.py)
    shard_logits: bool = False        # keep decode logits vocab-sharded
    kv_cache_dtype: str = "model"     # model | int8 (quantised KV cache)
    mla_absorb: bool = False          # MLA decode: absorb wkv_b into the
    # query/output (attention in latent space — no per-step re-expansion
    # of the cached latents; §Perf deepseek-v2 decode)
    # which attention kind: "full" archs skip long_500k (DESIGN.md)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.hd
        total = V * D  # embedding (tied head adds V*D if untied; we untie)
        total += V * D
        att = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.kv_lora_rank:
            q_in = self.q_lora_rank or D
            att = (D * self.q_lora_rank if self.q_lora_rank else 0)
            att += q_in * H * (hd + self.rope_head_dim)
            att += D * (self.kv_lora_rank + self.rope_head_dim)
            att += self.kv_lora_rank * H * (hd + hd)
            att += H * hd * D
        ffn_dense = 3 * D * F
        if self.family in ("ssm", "hybrid"):
            inner = self.num_heads * self.ssm_head_dim
            ssm = D * (2 * inner + 2 * self.ssm_state + self.num_heads)
            ssm += inner * D + self.conv_width * (inner + 2 * self.ssm_state)
            total += L * ssm
            if self.family == "hybrid":
                total += att + ffn_dense  # one shared attention block
            return total
        per_layer = att + ffn_dense
        if self.is_moe:
            moe = 3 * D * self.moe_d_ff * (self.num_experts
                                           + self.num_shared_experts)
            moe += D * self.num_experts  # router
            n_rest = L - self.first_dense_layers
            n_moe = n_rest // self.moe_every
            n_dense = self.first_dense_layers + (n_rest - n_moe)
            per_layer = att
            total += n_dense * ffn_dense + n_moe * moe
        total += L * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * (att + ffn_dense)
        return total

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        k = self.num_experts_per_tok + self.num_shared_experts
        D = self.d_model
        act_moe = 3 * D * self.moe_d_ff * k
        full_moe = 3 * D * self.moe_d_ff * (self.num_experts
                                            + self.num_shared_experts)
        n_moe = (self.num_layers - self.first_dense_layers) // self.moe_every
        return self.param_count() - n_moe * (full_moe - act_moe)


_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    smoke: ModelConfig
    source: str  # provenance note


def register(name: str, config: ModelConfig, smoke: ModelConfig,
             source: str) -> None:
    _REGISTRY[name] = ArchEntry(config, smoke, source)


ARCH_IDS = [
    "qwen2-1.5b", "deepseek-7b", "command-r-35b", "llama3.2-3b",
    "mamba2-130m", "internvl2-76b", "deepseek-v2-236b",
    "llama4-maverick-400b-a17b", "zamba2-1.2b", "whisper-small",
]

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-7b": "deepseek_7b",
    "command-r-35b": "command_r_35b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-130m": "mamba2_130m",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-small": "whisper_small",
}


def get_arch(name: str) -> ArchEntry:
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchEntry]:
    for name in ARCH_IDS:
        get_arch(name)
    return dict(_REGISTRY)
