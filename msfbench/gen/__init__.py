"""Frozen graph generators of the benchmark."""
