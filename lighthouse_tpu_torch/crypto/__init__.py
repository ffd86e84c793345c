"""Cryptography layer: BLS12-381 (counterpart of lighthouse_tpu/crypto).

The pairing-friendly curve arithmetic lives in `bls12_381/` (host
reference implementation, pure Python bigints); the batch-verification
device path lives in `lighthouse_tpu_torch.ops.bls381*` behind the `cuda`
backend of `bls/`.
"""
