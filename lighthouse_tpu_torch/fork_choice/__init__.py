"""Fork choice (consensus/{fork_choice,proto_array} equivalent).

Counterpart of lighthouse_tpu/fork_choice/__init__.py, copied.

`proto_array` is the columnar (array-program) implementation;
`proto_array_reference` retains the scalar walk as the differential
oracle.
"""

from .fork_choice import (
    Checkpoint,
    ForkChoice,
    ForkChoiceError,
    ForkChoiceStore,
    InvalidAttestation,
    InvalidBlock,
)
from .proto_array import (
    ExecutionStatus,
    ProtoArray,
    ProtoArrayError,
    ProtoArrayForkChoice,
)
from .proto_array_reference import (
    ProtoArrayForkChoiceReference,
    ProtoArrayReference,
    ProtoNode,
    VoteTracker,
)

__all__ = [
    "Checkpoint",
    "ForkChoice",
    "ForkChoiceError",
    "ForkChoiceStore",
    "InvalidAttestation",
    "InvalidBlock",
    "ExecutionStatus",
    "ProtoArray",
    "ProtoArrayError",
    "ProtoArrayForkChoice",
    "ProtoArrayForkChoiceReference",
    "ProtoArrayReference",
    "ProtoNode",
    "VoteTracker",
]
