"""llama4-maverick-400b-a17b — GQA kv=8, MoE 128e top-1 + shared expert
[hf:meta-llama/Llama-4 family; unverified].  Early-fusion multimodality is
out of backbone scope (spec: frontend stubs are for [vlm]/[audio] only)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=16384,
    vocab_size=202048, moe_d_ff=8192, num_experts=128,
    num_experts_per_tok=1, num_shared_experts=1, first_dense_layers=0,
    moe_every=2, rope_theta=500_000.0)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=512,
    moe_d_ff=64, num_experts=4, num_experts_per_tok=1,
    num_shared_experts=1, moe_every=2)

register("llama4-maverick-400b-a17b", CONFIG, SMOKE,
         "hf:meta-llama/Llama-4-Scout/Maverick cards")
