"""The LM scaffolding's models in plain PyTorch (the port of
``repro.models``): layers, SSM, MoE, the six model families, the
partition rules, and the conversion of reference trees."""
