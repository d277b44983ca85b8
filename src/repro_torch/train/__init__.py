"""LM training in plain PyTorch (the port of ``repro.train``): AdamW,
gradient compression, checkpoints in the reference's format and the
train loop."""
