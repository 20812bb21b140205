"""The 2-tx transfer block with a tampered signature (tests/test_accel_verify.py):
the port must reject it as the JAX package's accelerated path does, with the
same error class and kind (tests/torch_carry.py)."""

from torch_carry import rejected_alike
from xelis_he_tpu import verify_batch as jax_verify_batch
from xelis_he_tpu.ops.accel import Accelerator as JaxAccelerator
from xelis_he_tpu_torch import verify_batch
from xelis_he_tpu_torch.ops.accel import Accelerator


def test_tampered_signature_rejected_like_jax():
    want, got = rejected_alike(
        "signature", jax_verify_batch, JaxAccelerator("numpy"),
        verify_batch, Accelerator(device="cpu", tile=8, qtile=8),
    )
    assert want is not None and want[0] == "ProofVerificationError"
    assert got == want
