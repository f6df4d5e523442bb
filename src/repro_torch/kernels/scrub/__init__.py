"""Fused SECDED scrub sweep: decode, correct and census in one pass."""
