"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=24, num_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, subquadratic=True)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=2, num_kv_heads=0, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=16, subquadratic=True)

register("mamba2-130m", CONFIG, SMOKE, "arXiv:2405.21060")
