"""Serving: the MSF gateway (``msf_gateway.py``)."""
