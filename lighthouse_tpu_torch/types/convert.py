"""The state carrier: SSZ bytes in, the port's BeaconState out.

A state crosses from any other implementation (the JAX package's
`state.serialize()`, a checkpoint-sync download, a stored state) as its
SSZ bytes, which both packages decode to equal values and equal roots.
"""

from __future__ import annotations

from .chain_spec import ForkName
from .containers import build_types


def state_from_ssz(data: bytes, fork: ForkName | str, E: type):
    """Decode `data` as the `fork` BeaconState of preset `E` (an EthSpec
    subclass of this package)."""
    cls = build_types(E).types_for_fork(ForkName(fork)).BeaconState
    return cls.deserialize(bytes(data))
