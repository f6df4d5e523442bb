"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Each kernel package has two Python files; the CUDA sources live in
``repro_torch/csrc/``:
  * ``ops.py`` — the dispatching wrapper: the plain version for a CPU
    tensor, the kernel for a CUDA tensor (or an error — never a fallback);
  * ``ref.py`` — the plain PyTorch version the CPU tests and the card's
    bit-exact checks use.

Ported (with their TPU originals in ``repro/kernels/``):
  secded    Hsiao(72,64) encode / decode-correct       csrc/secded.cu
  mixed     fused mixed-pool read (read_correct) and   csrc/mixed.cu
            its router-fused sharded form
            (read_correct_routed)
  migrate   migration wrap gather + SECDED re-encode   csrc/migrate.cu
  parity8   8-bit-per-line parity encode / check       csrc/parity8.cu
  hash      fused hash probe + mixed gather + correct  csrc/hash.cu
  scrub     SECDED scrub sweep of (R, 9, W) rows       csrc/scrub.cu
  daec      SEC-DAEC(144,128) encode / decode-correct  csrc/daec.cu
  interwrap InterWrap page gather / in-place scatter   csrc/interwrap.cu
  flash_attention  causal GQA online-softmax attention csrc/flash_attention.cu
  ecc_matmul  SECDED decode-on-load bf16 A @ B, float32  csrc/ecc_matmul.cu

Shared device code: ``csrc/secded.cuh`` (Hsiao tables, in-register
correct) and ``csrc/coords.cuh`` (page -> (row, lane) of one slice).

Every Pallas kernel of the reference has its counterpart here.
"""
