"""Evaluation of the port (numpy metrics so far)."""
