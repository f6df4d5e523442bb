"""8-bit-per-line parity encode / check kernels (detection-only mode)."""
