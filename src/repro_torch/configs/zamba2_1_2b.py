"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, shared_attn_every=6,
    subquadratic=True)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=16, shared_attn_every=2,
    subquadratic=True)

register("zamba2-1.2b", CONFIG, SMOKE, "arXiv:2411.15242 / hf:Zyphra")
