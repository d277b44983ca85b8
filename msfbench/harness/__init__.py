"""The harness: cells, the traffic driver, spans, the device trace."""
