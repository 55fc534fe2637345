"""Measurement scripts of the port; each is run as a file on a CUDA card."""
