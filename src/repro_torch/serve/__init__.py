"""Serving: the MSF gateway (``msf_gateway.py``) and the LM decode engine
(``engine.py``)."""
