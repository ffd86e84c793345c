"""Shim: the snappy codec moved to utils (network framing uses it too).

Counterpart of lighthouse_tpu/testing/snappy.py, copied.
"""

from ..utils.snappy import (  # noqa: F401
    SnappyError,
    compress,
    decompress,
    decompress_frames,
    decompress_raw,
)
