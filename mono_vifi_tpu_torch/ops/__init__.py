"""Differentiable ops of the port."""
