"""Elementwise ops: activations, and the loss-function names."""
