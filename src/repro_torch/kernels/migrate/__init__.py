"""Migration gather fused with SECDED re-encode."""
