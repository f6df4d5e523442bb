"""The training example on the port prints the reference script's lines.

``repro_torch.examples.train_lm --steps 2 --ckpt <dir>`` on the CPU
against ``examples/train_lm.py`` with the same flags under JAX on the
CPU, each into an empty checkpoint directory of the same path (the
reference's is removed before the port's run): equal line for line, with
only the tok/s (the clock's) and the two loss values masked — those come
from each package's own random weights and are checked finite. The
parameter count and the scrub's five corrected flips in the moment pool
are compared as printed. The case takes ~110 s on a small CPU box
(~45 s the reference, ~65 s the port, whose plain SECDED codec encodes
and sweeps the 107M-parameter model's moment pool).
"""
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_examples import assert_same_output, masked, run_port, run_reference


def test_train_lm_prints_the_reference_lines(tmp_path):
    ckpt = tmp_path / "ckpt"
    args = ["--steps", "2", "--ckpt", str(ckpt)]
    ref = run_reference("train_lm", args)
    shutil.rmtree(ckpt, ignore_errors=True)
    port = run_port("train_lm", args)
    assert "resumed" not in port
    assert_same_output("train_lm", port, ref)


def test_the_mask_hides_the_clock_and_the_losses_only():
    a = "loss 10.060 -> 10.309 | 8 tok/s | checkpoints at /x"
    b = "loss 9.984 -> 10.343 | 12 tok/s | checkpoints at /x"
    assert masked("train_lm", a) == masked("train_lm", b)
    assert masked("train_lm", a) != masked("train_lm", b + "y")
    try:
        masked("train_lm", "loss nan -> 1.0 | 8 tok/s | checkpoints at /x")
    except AssertionError:
        pass
    else:
        raise AssertionError("a non-finite loss must not pass the mask")
