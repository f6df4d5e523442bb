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

Added on the card, with no Pallas original (the reference runs the step
in einsum):
  paged_decode  a decode step's GQA attention over paged  csrc/paged_decode.cu
                K/V views, live positions read once,
                split-KV with a deterministic combine

Shared device code: ``csrc/secded.cuh`` (Hsiao tables, in-register
correct), ``csrc/coords.cuh`` (page -> (row, lane) of one slice) and
``csrc/groups.cuh`` (a page's groups of 8 words fetched slice by slice).

Row widths: every pool kernel takes any W. At ``W % 8 == 0`` it launches
its vector entry (16-byte loads of whole 8-word groups of a slice), else
its word-granular ``<entry>_words``, counted under the same name
(``common.launch_for_width``). parity8 keeps the reference's PARITY rule
(its blocks hold a multiple of 4 lines). An empty batch returns empty
results on both devices and launches nothing.

Every Pallas kernel of the reference has its counterpart here.
"""
