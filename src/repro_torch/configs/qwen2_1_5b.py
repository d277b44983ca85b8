"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, d_ff=8960, vocab_size=151936,
    attn_bias=True, rope_theta=1_000_000.0)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    attn_bias=True)

register("qwen2-1.5b", CONFIG, SMOKE, "arXiv:2407.10671 Table 1 / hf")
