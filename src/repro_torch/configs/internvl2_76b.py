"""internvl2-76b — InternViT frontend (STUB) + llama3-70B-class backbone
[arXiv:2404.16821; unverified].  Patch embeddings arrive precomputed."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    rope_theta=500_000.0, frontend="patch", frontend_len=256)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    frontend="patch", frontend_len=8)

register("internvl2-76b", CONFIG, SMOKE, "arXiv:2404.16821")
