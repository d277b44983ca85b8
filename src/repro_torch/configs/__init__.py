"""Architecture configs of the LM scaffolding (the port's copy of
``repro.configs``)."""
