"""lighthouse_tpu_torch: the PyTorch and CUDA port of lighthouse_tpu.

The same beacon-node layers as lighthouse_tpu, with the same module tree and
names, written for PyTorch on an NVIDIA H100: every device kernel of the
JAX package is a kernel written by hand for Hopper (``csrc/``), bound to
PyTorch, with a plain PyTorch version beside it. The port imports nothing
of JAX or of lighthouse_tpu; its tests hold it to that package.

Ported so far: the SSZ layer and consensus types up to
``BeaconState.hash_tree_root()``, on the SHA-256 kernel
(``ops/sha256.py``, ``csrc/sha256.cu``; slice 1); BLS batch signature
verification, ``crypto.bls.verify_signature_sets`` under the ``cuda``
backend, on the BLS12-381 kernels (``ops/bls381*.py``,
``csrc/bls381_*``; slice 2); the state transition,
``state_processing.per_slot_processing`` / ``per_block_processing``, with
the Altair epoch sweep on its kernel (``ops/epoch_sweep.py``,
``csrc/epoch_sweep.cu``; slice 3), through Electra, with genesis, fork
choice and the conformance runner (``testing/ef_tests.py``); blob data
availability and the multi-device step (slices 4 and 5). The device policy
is in ``device.py``:
kernels run on ``cuda`` unless the caller asks for the CPU.
"""

from .device import default_device, resolve_device, set_default_device

__version__ = "0.1.0"

__all__ = ["default_device", "resolve_device", "set_default_device"]
