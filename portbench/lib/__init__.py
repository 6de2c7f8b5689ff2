"""The harness: traffic, weights, the reference, the check, the trace."""
