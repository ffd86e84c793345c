"""Runtime sanitizer for the tree-states protocol (see sanitizer.py)."""

from .sanitizer import SanitizerError, enabled as sanitize_enabled  # noqa: F401
