"""command-r-35b — dense GQA kv=8, no bias, parallel attn+FFN block
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", num_layers=40, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22528, vocab_size=256000,
    parallel_block=True, rope_theta=8_000_000.0)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=512,
    parallel_block=True)

register("command-r-35b", CONFIG, SMOKE, "hf:CohereForAI/c4ai-command-r-v01")
