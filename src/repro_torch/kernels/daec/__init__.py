"""SEC-DAEC(144,128) encode / decode-correct kernels."""
