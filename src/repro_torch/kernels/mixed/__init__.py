"""Fused mixed-pool page read."""
