"""Where the port's kernels run.

The default device is ``cuda``: every batch above the size thresholds of
the SSZ layer (``ssz/merkle.py``, ``ssz/cached_tree_hash.py``,
``utils/sha256_batch.py``) goes to a hand-written kernel on the card, or
the dispatch raises. A caller that wants the CPU asks for it, with
``set_default_device("cpu")`` or a ``device=`` argument; there each
kernel's plain PyTorch version runs instead. Nothing falls back from the
card to the CPU: with the device ``cuda`` and no card, the first kernel
dispatch raises.

Batches below the thresholds stay on the host hashlib loop whatever the
device: that is the JAX package's own size dispatch, not a fallback.

A process forked from one that holds a CUDA context cannot use the card,
and must not compute a kernel's work on the CPU in its place either. The
Beacon API's serving workers (``http_api/workers.py``) mark themselves
with ``mark_forked_worker()`` right after the fork; from then on every
dispatch raises ``ForkedWorkerDispatch``, which the worker answers by
forwarding the request to its parent.
"""

from __future__ import annotations

import torch

_default = torch.device("cuda")
_forked_worker = False


class ForkedWorkerDispatch(RuntimeError):
    """A kernel dispatch in a process marked as a forked worker."""


def mark_forked_worker() -> None:
    """Refuse every later kernel dispatch in this process (a forked child)."""
    global _forked_worker
    _forked_worker = True


def set_default_device(device: str | torch.device) -> None:
    """Set the device that kernel dispatches use when given none."""
    global _default
    _default = _check(torch.device(device))


def default_device() -> torch.device:
    return _default


def _check(dev: torch.device) -> torch.device:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device`, or the default one, checked for a kernel dispatch.

    Raises RuntimeError for a CUDA device when no card is present, and
    ForkedWorkerDispatch on any device in a forked worker.
    """
    if _forked_worker:
        raise ForkedWorkerDispatch(
            "kernel dispatch in a forked worker: the request goes to the parent"
        )
    dev = _check(torch.device(device)) if device is not None else _default
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kernel dispatch on device 'cuda', but torch.cuda.is_available() "
            "is false; call set_default_device('cpu') to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
