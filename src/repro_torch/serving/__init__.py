"""Paged fused-step serving engine of the port."""
