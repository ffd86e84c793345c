"""beacon-san: the project's AST lint and runtime sanitizer.

* `lint` — `python -m lighthouse_tpu_torch.analysis <paths>`, the rule
  families of the JAX package's linter over the port (its fork-safety
  vocabulary names torch and the kernel dispatch).
* `sanitizer` — runtime write-guards for the tree-states protocol.
"""

from .lint import RULES, Violation, lint_paths, lint_source, main  # noqa: F401
from .sanitizer import SanitizerError, enabled as sanitize_enabled  # noqa: F401
