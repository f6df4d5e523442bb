"""Fused hash-probe + mixed-pool page gather kernel (the objcache get path)."""
