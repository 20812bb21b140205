"""xelis_he_tpu_torch: confidential-transaction cryptography on PyTorch and CUDA.

The port of ``xelis_he_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
public API (Twisted ElGamal balances on ristretto255, Schnorr signatures,
sigma proofs, aggregated Bulletproofs, block verification), with the host
layer kept as a byte-identical copy and the device path rebuilt on torch
tensors and hand-written CUDA kernels (``ops/kernels.py``, ``csrc/``).

Block verification on the card: ``verify_batch(txs, state,
accel=xelis_he_tpu_torch.ops.accel.Accelerator())``.
"""

from . import scalars
from .elgamal import (
    DecryptHandle,
    ECDLPInstance,
    ElGamalCiphertext,
    ElGamalKeypair,
    ElGamalPubkey,
    ElGamalSecretKey,
    H,
    PedersenCommitment,
    PedersenOpening,
    Signature,
)
from .errors import (
    CipherFormatError,
    DecompressionError,
    InsufficientFundsError,
    InvalidNonceError,
    ProofGenerationError,
    ProofVerificationError,
    TranscriptError,
)
from .extra_data import ExtraData, PlaintextData
from .pyref.ristretto import BASEPOINT as G, IDENTITY, RistrettoPoint, mul_base
from .sigma import BatchCollector, CiphertextValidityProof, CommitmentEqProof
from .transcript import ProtocolTranscript
from .types import (
    CompressedCiphertext,
    CompressedCommitment,
    CompressedHandle,
    CompressedPubkey,
    Hash,
    NATIVE_ASSET,
    Role,
)
from .tx.model import (
    BurnPayload,
    DeployContractPayload,
    MultiSigPayload,
    NewSourceCommitment,
    SmartContractCall,
    Transaction,
    Transfer,
)
from .tx.builder import (
    BurnBuilder,
    DeployContractBuilder,
    GetBlockchainAccountBalance,
    MultiSigBuilder,
    SmartContractCallBuilder,
    TransactionBuilder,
    TransactionUnsigned,
    TransferBuilder,
    TransfersBuilder,
    build_batch,
)
from .tx.verify import (
    BlockchainVerificationState,
    apply_without_verify,
    pre_verify,
    verify,
    verify_batch,
)

__version__ = "0.1.0"
