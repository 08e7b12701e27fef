"""Datasets, the frame cache and the input pipeline of the port."""
