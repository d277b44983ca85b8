"""whisper-small — enc-dec, conv frontend STUB (precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_layers=12, cross_attention=True, frontend="audio",
    frontend_len=1500)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    encoder_layers=2, cross_attention=True, frontend="audio",
    frontend_len=16)

register("whisper-small", CONFIG, SMOKE, "arXiv:2212.04356 Table 1")
