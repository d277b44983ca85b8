"""deepseek-v2-236b — MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared
[arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=12288, vocab_size=102400,
    head_dim=128, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, first_dense_layers=1)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16,
    kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
    num_experts=8, num_experts_per_tok=2, num_shared_experts=1,
    moe_d_ff=32, first_dense_layers=1)

register("deepseek-v2-236b", CONFIG, SMOKE, "arXiv:2405.04434 §2")
