"""Numpy reference forwards the port's parity tests hold it to."""
