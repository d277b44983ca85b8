"""deepseek-7b — llama-architecture dense, GQA kv=32 (MHA) [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=102400)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=512)

register("deepseek-7b", CONFIG, SMOKE, "arXiv:2401.02954 / hf")
