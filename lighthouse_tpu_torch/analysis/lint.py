"""beacon-san: project-specific AST lint for the tree-states protocol.

Counterpart of lighthouse_tpu/analysis/lint.py, copied; the fork-safety
vocabulary names the port's hazard (torch and its kernel dispatch in a
forked child) where the reference names jax.

Four rule families, each enforcing an invariant this codebase previously
kept by convention only (the shape of the reference's `safe_arith` crate
and milhouse `&mut` discipline, as a linter instead of a type system):

* ``safe-arith`` — raw ``+ - * //`` on recognized uint64 state
  quantities inside ``state_processing/`` / ``fork_choice/`` /
  ``slasher/`` must route through `lighthouse_tpu_torch/utils/safe_arith`
  (checked scalar helpers, wide-checked vectorized helpers). Recognized
  quantities: ``*.effective_balance`` reads, ``state.balances[...]`` /
  ``state.slashings[...]`` / ``state.inactivity_scores[...]`` and
  proto-array ``_weights[...]`` / ``_balances[...]`` subscripts, values
  produced by ``load_balances()`` / ``load_inactivity_scores()`` /
  ``load_array()`` and the slasher span gathers ``gather_min()`` /
  ``gather_max()``, and names assigned from any of those within the
  same function.

* ``cow-aliasing`` — arrays obtained from `PersistentList.load_array`,
  `CommitteeCache.committee_array`, or RegistryColumns / EpochArrays
  column views are zero-copy reads of CoW-shared storage: writing them
  (subscript stores, augmented stores, ``setflags(write=True)``)
  corrupts every aliased consumer. Writes must go through the sanctioned
  writers (``store_array`` / ``write_participation`` / ``_write_col`` /
  `EpochArrays.write_snapshot_rows`).

* ``fork-safety`` — callables submitted to the `parallel/host_pool`
  fork pool, and entry functions passed to the serving-worker fork
  entry (`http_api/workers.spawn_serving_worker`), run in children
  that inherit parent locks as-held: worker functions (and their
  same-module callees, plus a one-hop import resolve) must not touch
  the metrics registry, logging, tracing spans, torch or the port's
  kernel dispatch (a CUDA context does not survive ``fork``), or locks.
  A worker that uses torch on the CPU on purpose carries a suppression
  with its reason.
  Lambdas/closures can capture anything, so only module-level
  functions are allowed.

* ``dirty-channel`` — `drain_dirty(name)` consumers must name their
  channel with a module-level constant that the same module registers /
  commits via ``channel()`` or ``dirt_token_for()``; and a ``mutate()`` /
  ``mutable_validator()`` write handle may not be written after a
  channel-draining call in the same function (drains re-freeze
  outstanding handles — the rule documented at
  accessors._fresh_columns).

* ``queue-discipline`` — callables registered to run on a socket reader
  thread (`gossip.subscribe` handlers, `gossip.subscribe_queued` decode
  steps) must not call chain state transitions (``chain.process_*``,
  ``per_block_processing``); that work must ride a beacon_processor
  lane (the `process=` step of ``subscribe_queued``) so gossip storms
  back up drop-counted queues instead of sockets.

Suppression: ``# lint: allow(rule[, rule]) -- reason`` on the violating
line or the line directly above it. ``# lint: allow-file(rule) -- reason``
within the first 20 lines suppresses a rule for the whole file. A
suppression without a reason is itself a violation.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

RULES = (
    "safe-arith",
    "cow-aliasing",
    "fork-safety",
    "dirty-channel",
    "metric-hygiene",
    "queue-discipline",
)

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*(allow|allow-file)\(([a-z\-,\s]+)\)(?:\s*--\s*(\S.*))?"
)

# -- safe-arith vocabulary ---------------------------------------------------

_U64_ATTRS = {"effective_balance"}
# `_weights` / `_balances` are the fork-choice proto-array's uint64
# columns (node weights and justified-state balances):
# balance deltas are u64 quantities and must ride the checked helpers
_U64_SUBSCRIPT_BASES = {
    "balances",
    "slashings",
    "inactivity_scores",
    "_weights",
    "_balances",
}
_U64_PRODUCER_CALLS = {
    "load_balances",
    "load_inactivity_scores",
    "load_array",
    # the slasher's span gathers (slasher/spans.py) yield uint16 distance
    # lanes; raw arithmetic on them wraps at the clamp ceiling exactly
    # like the u64 columns — route through safe_arith or compare only
    "gather_min",
    "gather_max",
}
_RAW_OPS = (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv)
_OP_GLYPH = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.FloorDiv: "//"}

# das/-scoped additions: sidecar `.index` reads and the column/
# point index producers are uint64-lane quantities in the PeerDAS spec.
# Scoped to das/ only — `.index` is far too generic a name to taint
# globally (list.index(), validator registries, ...), and the FR field
# arithmetic that dominates das/erasure.py is bigint-mod-p math that must
# NOT be pushed through the u64 checked helpers.
_DAS_U64_ATTRS = {"index"}
_DAS_U64_PRODUCER_CALLS = {"cell_point_index", "column_subnet"}

# validator_client/-scoped additions: the VC duty cycle is
# epoch/slot bookkeeping end to end — duty slots, checkpoint epochs, and
# the slashing-protection watermark epochs are uint64 wire quantities.
# Scoped to validator_client/ only: `.slot` / `.epoch` are too generic
# to taint globally (every SSZ container carries a slot), but inside the
# VC every such read IS the consensus quantity.
_VC_U64_ATTRS = {"slot", "epoch", "target_epoch", "source_epoch"}
_VC_U64_PRODUCER_CALLS = {
    "compute_epoch_at_slot",
    "compute_start_slot_at_epoch",
}

# store/-scoped additions: the migration cycle's slot math —
# finalized-boundary slots and the DA availability cutoff — are uint64
# consensus quantities; a raw subtraction there underflows exactly where
# the reference uses saturating_sub. Attrs stay empty: `.slot` is too
# generic even inside store/ (the migrator's epoch-claim bookkeeping is
# plain Python ints by design), so only the producer calls taint.
_STORE_U64_ATTRS: set[str] = set()
_STORE_U64_PRODUCER_CALLS = {
    "compute_start_slot_at_epoch",
    "da_window_slots",
}

# -- cow-aliasing vocabulary -------------------------------------------------

_VIEW_PRODUCER_CALLS = {"load_array", "committee_array"}
_COLUMN_VIEW_ATTRS = {
    "effective_balance",
    "activation_eligibility_epoch",
    "activation_epoch",
    "exit_epoch",
    "withdrawable_epoch",
    "slashed",
    "withdrawal_credentials",
    "pubkey_root",
    "balances",
    "inactivity_scores",
    "previous_epoch_participation",
    "current_epoch_participation",
    "prev_participation",
    "curr_participation",
    "shuffled",
}
_COLUMN_RECEIVERS = {"cols", "columns", "arrays", "cc", "cache"}

# -- fork-safety vocabulary --------------------------------------------------

_POOL_METHODS = {"map", "submit"}
#: module-level functions whose FIRST positional argument is a forked
#: serving-worker entrypoint (http_api/workers.spawn_serving_worker) —
#: scanned with exactly the host_pool worker discipline
_FORK_ENTRY_CALLS = {"spawn_serving_worker"}
_FORBIDDEN_WORKER_NAMES = {
    "REGISTRY": "the metrics registry",
    "inc_counter": "the metrics registry",
    "set_gauge": "the metrics registry",
    "observe": "the metrics registry",
    "start_timer": "the metrics registry",
    "set_distribution": "the metrics registry",
    "span": "a tracing span (metrics histograms + contextvars)",
    "traced": "a tracing span (metrics histograms + contextvars)",
    "get_logger": "the logging subsystem",
    "logging": "the logging subsystem",
    "logger": "the logging subsystem",
    "log": "the logging subsystem",
    "torch": "torch (a CUDA context does not survive fork)",
    "resolve_device": "the kernel dispatch (a CUDA context does not survive fork)",
    "CudaLibrary": "the kernel dispatch (a CUDA context does not survive fork)",
    "threading": "a lock-bearing threading object",
    "Lock": "a lock",
    "RLock": "a lock",
}

# -- metric-hygiene vocabulary -----------------------------------------------

#: helpers whose FIRST positional argument is a metric/span name
_METRIC_NAME_CALLS = {
    "span",
    "traced",
    "inc_counter",
    "set_gauge",
    "observe",
    "set_distribution",
    "start_timer",
}
#: registry methods whose first argument is a collector name
_REGISTRY_METHODS = {"counter", "gauge", "histogram"}

# -- queue-discipline vocabulary ---------------------------------------------

#: gossip registration methods -> index of the positional arg that runs
#: INLINE on the socket reader thread (`subscribe(topic, handler)` /
#: `subscribe_queued(topic, work_type, decode, ...)`); the queued
#: `process=`/`process_batch=` callables are exempt by design — they run
#: on beacon_processor workers
_GOSSIP_REGISTER_METHODS = {"subscribe": (1, "handler"), "subscribe_queued": (2, "decode")}
#: chain state-transition entry points a reader-thread callable must
#: never reach — they belong behind BeaconProcessor.submit
_STATE_TRANSITION_CALLS = {
    "process_block",
    "process_chain_segment",
    "process_attestation_batch",
    "process_aggregate",
    "process_voluntary_exit",
    "process_proposer_slashing",
    "process_attester_slashing",
    "process_sync_committee_message",
    "process_blob_sidecars",
    "process_data_column_sidecars",
    "per_block_processing",
}

# -- dirty-channel vocabulary ------------------------------------------------

_HANDLE_CALLS = {"mutate", "mutable_validator"}
_DRAINING_CALLS = {
    "refresh",
    "try_refresh",
    "drain_dirty",
    "_fresh_columns",
    "refresh_rows",
    "load_balances",
    "load_inactivity_scores",
    "get_total_active_balance",
    "get_validator_churn_limit",
    "get_beacon_proposer_index",
    "get_active_validator_indices",
    "active_validator_indices_array",
    "committee_cache_at",
    "get_beacon_committee",
    "attesting_indices_array",
    "get_attesting_indices",
    "initiate_validator_exit",
    "initiate_validator_exit_electra",
    "slash_validator",
}


@dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


def _comments(source: str):
    """(line, text) for every comment token — tokenize-based so string
    literals and docstrings that mention the allow syntax never count."""
    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError):
        return


class _Suppressions:
    def __init__(self, source: str, path: str):
        self.line_allows: dict[int, set[str]] = {}
        self.file_allows: set[str] = set()
        self.malformed: list[Violation] = []
        for i, line in _comments(source):
            m = _ALLOW_RE.search(line)
            if not m:
                continue
            kind, rules_raw, reason = m.groups()
            rules = {r.strip() for r in rules_raw.split(",") if r.strip()}
            if not reason:
                self.malformed.append(
                    Violation(
                        path,
                        i,
                        "suppression",
                        "lint suppression without a reason "
                        "(`# lint: allow(rule) -- reason`)",
                    )
                )
                continue
            unknown = rules - set(RULES)
            if unknown:
                self.malformed.append(
                    Violation(
                        path,
                        i,
                        "suppression",
                        f"unknown lint rule(s) in suppression: "
                        f"{', '.join(sorted(unknown))}",
                    )
                )
                rules -= unknown
            if kind == "allow-file":
                if i <= 20:
                    self.file_allows |= rules
                else:
                    self.malformed.append(
                        Violation(
                            path,
                            i,
                            "suppression",
                            "allow-file must appear in the first 20 lines",
                        )
                    )
            else:
                self.line_allows.setdefault(i, set()).update(rules)

    def allows(self, rule: str, line: int) -> bool:
        if rule in self.file_allows:
            return True
        for ln in (line, line - 1):
            if rule in self.line_allows.get(ln, set()):
                return True
        return False


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_u64_source(
    node: ast.AST,
    tainted: set[str],
    extra_attrs: frozenset = frozenset(),
    extra_producers: frozenset = frozenset(),
) -> bool:
    if isinstance(node, ast.Attribute) and (
        node.attr in _U64_ATTRS or node.attr in extra_attrs
    ):
        return True
    if isinstance(node, ast.Subscript):
        base = node.value
        if isinstance(base, ast.Attribute) and base.attr in _U64_SUBSCRIPT_BASES:
            return True
        if isinstance(base, ast.Name) and base.id in tainted:
            return True
    if isinstance(node, ast.Call) and (
        _call_name(node) in _U64_PRODUCER_CALLS
        or _call_name(node) in extra_producers
    ):
        return True
    if isinstance(node, ast.Name) and node.id in tainted:
        return True
    return False


def _is_view_producer(node: ast.AST) -> bool:
    """An expression that yields a zero-copy CoW-shared read view."""
    if isinstance(node, ast.Call) and _call_name(node) in _VIEW_PRODUCER_CALLS:
        return True
    if isinstance(node, ast.Attribute) and node.attr in _COLUMN_VIEW_ATTRS:
        v = node.value
        if isinstance(v, ast.Name) and v.id in _COLUMN_RECEIVERS:
            return True
        if isinstance(v, ast.Attribute) and v.attr in ("columns", "cols"):
            return True
    return False


def _function_scopes(tree: ast.Module):
    """Yield (scope_node, body) for the module and every function."""
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def _walk_scope(body):
    """Walk statements of one scope without descending into nested
    function definitions (they get their own scope pass)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested scope: linted by its own pass
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# Rule: safe-arith
# ---------------------------------------------------------------------------


def _check_safe_arith(tree: ast.Module, path: str) -> list[Violation]:
    p = path.replace("\\", "/")
    # fork_choice is in the rule's scope for the columnar proto-array:
    # its weight/balance columns are the same uint64 register the
    # epoch sweeps use. slasher/ is in it for the columnar span
    # subsystem: span distances and epoch arithmetic are uint-lane
    # quantities (the retained reference.py carries an allow-file).
    # das/ joined with the PeerDAS subsystem, with its own vocab:
    # sidecar indices and column/point derivations are the uint lanes
    # there (the FR field math is bigint-mod-p and stays out of scope).
    # state_advance.py joined with the proposer pipeline: the
    # pre-advance drives per_slot_processing over the same uint64 state
    # quantities the epoch sweeps mutate.
    # validator_client/ joined with the batched duty pipeline,
    # with its own epoch/slot vocabulary (see _VC_U64_ATTRS).
    # store/ joined with the lifecycle subsystem: the migrator's
    # finalized-slot / DA-cutoff arithmetic is uint64 slot math (see
    # _STORE_U64_PRODUCER_CALLS).
    das_scoped = "lighthouse_tpu_torch/das" in p
    vc_scoped = "lighthouse_tpu_torch/validator_client" in p
    store_scoped = "lighthouse_tpu_torch/store" in p
    if (
        "state_processing" not in p
        and "fork_choice" not in p
        and "slasher" not in p
        and "state_advance" not in p
        and not das_scoped
        and not vc_scoped
        and not store_scoped
    ):
        return []
    extra_attrs = frozenset()
    extra_producers = frozenset()
    if das_scoped:
        extra_attrs |= frozenset(_DAS_U64_ATTRS)
        extra_producers |= frozenset(_DAS_U64_PRODUCER_CALLS)
    if vc_scoped:
        extra_attrs |= frozenset(_VC_U64_ATTRS)
        extra_producers |= frozenset(_VC_U64_PRODUCER_CALLS)
    if store_scoped:
        extra_attrs |= frozenset(_STORE_U64_ATTRS)
        extra_producers |= frozenset(_STORE_U64_PRODUCER_CALLS)

    def is_source(node, tainted):
        return _is_u64_source(node, tainted, extra_attrs, extra_producers)

    out: list[Violation] = []
    for _scope, body in _function_scopes(tree):
        tainted: set[str] = set()
        # two passes so `a = state.balances[i]; b = a` taints b
        for _ in range(2):
            for node in _walk_scope(body):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.AST
                ):
                    if is_source(node.value, tainted):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
        for node in _walk_scope(body):
            if isinstance(node, ast.BinOp) and isinstance(node.op, _RAW_OPS):
                if is_source(node.left, tainted) or is_source(
                    node.right, tainted
                ):
                    glyph = _OP_GLYPH[type(node.op)]
                    out.append(
                        Violation(
                            path,
                            node.lineno,
                            "safe-arith",
                            f"raw `{glyph}` on a uint64 state quantity; "
                            f"route through lighthouse_tpu_torch/utils/safe_arith "
                            f"(safe_{_op_word(node.op)} / "
                            f"{_op_word(node.op)}_u64)",
                        )
                    )
            elif isinstance(node, ast.AugAssign) and isinstance(
                node.op, _RAW_OPS
            ):
                if is_source(node.target, tainted) or is_source(
                    node.value, tainted
                ):
                    glyph = _OP_GLYPH[type(node.op)]
                    out.append(
                        Violation(
                            path,
                            node.lineno,
                            "safe-arith",
                            f"raw `{glyph}=` on a uint64 state quantity; "
                            f"route through lighthouse_tpu_torch/utils/safe_arith",
                        )
                    )
    return out


def _op_word(op) -> str:
    return {
        ast.Add: "add",
        ast.Sub: "sub",
        ast.Mult: "mul",
        ast.FloorDiv: "div",
    }[type(op)]


# ---------------------------------------------------------------------------
# Rule: cow-aliasing
# ---------------------------------------------------------------------------


def _check_cow_aliasing(tree: ast.Module, path: str) -> list[Violation]:
    out: list[Violation] = []

    # class-level: self attributes ever assigned from a view producer
    view_self_attrs: dict[str, set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            attrs: set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and _is_view_producer(sub.value):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            attrs.add(t.attr)
            if attrs:
                view_self_attrs[node.name] = attrs
    all_view_attrs = set().union(*view_self_attrs.values()) if view_self_attrs else set()

    def _is_view_expr(node: ast.AST, tainted: set[str]) -> bool:
        if _is_view_producer(node):
            return True
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in all_view_attrs
        ):
            return True
        return False

    for _scope, body in _function_scopes(tree):
        tainted: set[str] = set()
        for _ in range(2):
            for node in _walk_scope(body):
                if isinstance(node, ast.Assign) and _is_view_expr(
                    node.value, tainted
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            tainted.add(t.id)
        for node in _walk_scope(body):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and _is_view_expr(
                    t.value, tainted
                ):
                    out.append(
                        Violation(
                            path,
                            node.lineno,
                            "cow-aliasing",
                            "write into a zero-copy CoW view "
                            "(load_array / committee_array / column view); "
                            "use the sanctioned writers "
                            "(store_array / write_participation / "
                            "write_snapshot_rows) or copy first",
                        )
                    )
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "setflags"
                and _is_view_expr(node.func.value, tainted)
            ):
                for kw in node.keywords:
                    if (
                        kw.arg == "write"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value
                    ):
                        out.append(
                            Violation(
                                path,
                                node.lineno,
                                "cow-aliasing",
                                "setflags(write=True) re-enables writes on "
                                "a frozen CoW view",
                            )
                        )
    return out


# ---------------------------------------------------------------------------
# Rule: fork-safety
# ---------------------------------------------------------------------------


def _mentions_pool(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "pool" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "pool" in node.attr.lower() or _mentions_pool(node.value)
    if isinstance(node, ast.Call):
        return _mentions_pool(node.func)
    return False


def _module_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    return {
        n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
    }


def _imported_from(tree: ast.Module) -> dict[str, tuple[int, str, str]]:
    """name -> (relative level, module, original name) for ImportFrom."""
    out = {}
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.module is not None:
            for alias in n.names:
                out[alias.asname or alias.name] = (
                    n.level,
                    n.module,
                    alias.name,
                )
    return out


def _scan_worker(
    fn: ast.FunctionDef,
    funcs: dict[str, ast.FunctionDef],
    visited: set[str],
) -> list[tuple[int, str, str]]:
    """(line, symbol, why) for forbidden references in `fn` and its
    same-module callees."""
    if fn.name in visited:
        return []
    visited.add(fn.name)
    findings = []
    callees = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            why = _FORBIDDEN_WORKER_NAMES.get(node.id)
            if why:
                findings.append((node.lineno, node.id, why))
            if isinstance(getattr(node, "ctx", None), ast.Load):
                callees.add(node.id)
        elif isinstance(node, ast.Attribute):
            why = _FORBIDDEN_WORKER_NAMES.get(node.attr)
            if why and node.attr in ("Lock", "RLock"):
                findings.append((node.lineno, node.attr, why))
    for name in callees:
        callee = funcs.get(name)
        if callee is not None:
            findings.extend(_scan_worker(callee, funcs, visited))
    return findings


def _resolve_import(
    path: Path, level: int, module: str, name: str
) -> ast.FunctionDef | None:
    """Best-effort one-hop resolve of `from .module import name` (or the
    absolute `from pkg.module import name`) to the FunctionDef in that
    module's file."""
    base = path.parent
    if level == 0:
        # absolute import: ascend until the top-level package is a
        # sibling (resolves `from lighthouse_tpu_torch.x.y import f` from
        # anywhere inside the repo checkout)
        top = module.split(".", 1)[0]
        while not (base / top).is_dir() and not (base / f"{top}.py").exists():
            if base == base.parent:
                return None
            base = base.parent
    for _ in range(max(0, level - 1)):
        base = base.parent
    target = base.joinpath(*module.split("."))
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        try:
            sub = ast.parse(cand.read_text())
        except (OSError, SyntaxError):
            continue
        fn = _module_functions(sub).get(name)
        if fn is not None:
            fn._lint_module = sub  # type: ignore[attr-defined]
            fn._lint_path = str(cand)  # type: ignore[attr-defined]
            return fn
    return None


def _check_fork_safety(tree: ast.Module, path: str) -> list[Violation]:
    out: list[Violation] = []
    funcs = _module_functions(tree)
    imports = _imported_from(tree)
    ppath = Path(path)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        is_pool = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _POOL_METHODS
            and _mentions_pool(node.func.value)
        )
        is_entry = (
            node.func.id in _FORK_ENTRY_CALLS
            if isinstance(node.func, ast.Name)
            else isinstance(node.func, ast.Attribute)
            and node.func.attr in _FORK_ENTRY_CALLS
        )
        if not (is_pool or is_entry):
            continue
        where = "the fork pool" if is_pool else "the serving-worker fork entry"
        worker = node.args[0]
        if isinstance(worker, ast.Lambda):
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "fork-safety",
                    f"lambda submitted to {where} — worker callables "
                    "must be module-level functions (closures capture "
                    "parent state, including locks)",
                )
            )
            continue
        if not isinstance(worker, ast.Name):
            continue  # e.g. host_pool internals re-submitting a parameter
        fn = funcs.get(worker.id)
        fn_path = path
        fn_funcs = funcs
        if fn is None and worker.id in imports:
            level, module, orig = imports[worker.id]
            fn = _resolve_import(ppath, level, module, orig)
            if fn is not None:
                fn_funcs = _module_functions(fn._lint_module)
                fn_path = fn._lint_path
        if fn is None:
            continue
        for line, symbol, why in _scan_worker(fn, fn_funcs, set()):
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "fork-safety",
                    f"worker `{worker.id}` reaches {symbol} "
                    f"({fn_path}:{line}) — {why}; forked children inherit "
                    f"parent locks as-held, keep workers lock-free and "
                    f"tally metrics parent-side",
                )
            )
    return out


# ---------------------------------------------------------------------------
# Rule: dirty-channel
# ---------------------------------------------------------------------------


def _check_dirty_channel(tree: ast.Module, path: str) -> list[Violation]:
    out: list[Violation] = []

    # registration sites: channel(NAME) / dirt_token_for(NAME)
    registered: set[str] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and _call_name(node) in ("channel", "dirt_token_for")
            and node.args
            and isinstance(node.args[0], ast.Name)
        ):
            registered.add(node.args[0].id)

    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call) and _call_name(node) == "drain_dirty"
        ):
            continue
        if not node.args:
            continue  # default hash channel (single-consumer API)
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "dirty-channel",
                    f"drain_dirty({arg.value!r}) with an inline string — "
                    f"name the channel with a module-level constant and "
                    f"register it via channel()/dirt_token_for()",
                )
            )
        elif isinstance(arg, ast.Name) and arg.id not in registered:
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "dirty-channel",
                    f"channel {arg.id} is drained here but this module "
                    f"never registers/commits it via "
                    f"channel()/dirt_token_for() — the consumer cannot "
                    f"prove its baseline",
                )
            )

    # mutate-handle writes after a draining call
    for _scope, body in _function_scopes(tree):
        acquisitions: dict[str, int] = {}
        drains: list[int] = []
        writes: list[tuple[str, int]] = []
        for node in _walk_scope(body):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if _call_name(node.value) in _HANDLE_CALLS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            acquisitions[t.id] = node.lineno
            if (
                isinstance(node, ast.Call)
                and _call_name(node) in _DRAINING_CALLS
            ):
                drains.append(node.lineno)
            tgts = []
            if isinstance(node, ast.Assign):
                tgts = node.targets
            elif isinstance(node, ast.AugAssign):
                tgts = [node.target]
            for t in tgts:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                ):
                    writes.append((t.value.id, node.lineno))
        for var, wline in writes:
            acq = acquisitions.get(var)
            if acq is None:
                continue
            if any(acq < d < wline for d in drains):
                out.append(
                    Violation(
                        path,
                        wline,
                        "dirty-channel",
                        f"write through mutate handle `{var}` after a "
                        f"channel-draining call — drains re-freeze "
                        f"outstanding handles; acquire the handle AFTER "
                        f"all reads",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Rule: queue-discipline
# ---------------------------------------------------------------------------


def _mentions_gossip(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return "gossip" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "gossip" in node.attr.lower() or _mentions_gossip(node.value)
    if isinstance(node, ast.Call):
        return _mentions_gossip(node.func)
    return False


def _all_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """name -> FunctionDef for module functions AND every class method
    (gossip handlers are almost always methods: `self._on_gossip_x`)."""
    out = dict(_module_functions(tree))
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out.setdefault(sub.name, sub)
    return out


def _scan_handler(
    fn: ast.FunctionDef,
    funcs: dict[str, ast.FunctionDef],
    visited: set[str],
) -> list[tuple[int, str]]:
    """(line, call name) for state-transition calls reachable from `fn`
    through same-module callees (methods resolved by name, one level of
    nesting at a time)."""
    if fn.name in visited:
        return []
    visited.add(fn.name)
    findings = []
    callees: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = None
        if isinstance(f, ast.Attribute):
            name = f.attr
        elif isinstance(f, ast.Name):
            name = f.id
        if name in _STATE_TRANSITION_CALLS:
            findings.append((node.lineno, name))
        elif name is not None:
            callees.add(name)
    for name in callees:
        callee = funcs.get(name)
        if callee is not None:
            findings.extend(_scan_handler(callee, funcs, visited))
    return findings


def _handler_aliases(tree: ast.Module) -> dict[str, str]:
    """Local-name aliases of functions/methods anywhere in the module
    (`decode = self._decode_x` / `h = on_block`): a handler registered
    through an alias must still resolve to its definition — a silently
    skipped alias would be a hole in the gate (found by review: the
    package's own attestation decode briefly registered through one)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if not isinstance(t, ast.Name):
            continue
        v = node.value
        if isinstance(v, ast.Attribute):
            out[t.id] = v.attr
        elif isinstance(v, ast.Name):
            out[t.id] = v.id
    return out


def _check_queue_discipline(tree: ast.Module, path: str) -> list[Violation]:
    """Callables registered to run on a socket reader thread — the
    `handler` of `gossip.subscribe` and the `decode` of
    `gossip.subscribe_queued` — must not execute chain state transitions
    (`chain.process_*`, `per_block_processing`): that work belongs on a
    beacon_processor lane via `subscribe_queued`'s `process=` step, so a
    gossip storm backs up queues (drop-counted) instead of sockets."""
    out: list[Violation] = []
    funcs = _all_functions(tree)
    aliases = _handler_aliases(tree)
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _GOSSIP_REGISTER_METHODS
            and _mentions_gossip(node.func.value)
        ):
            continue
        pos, kw_name = _GOSSIP_REGISTER_METHODS[node.func.attr]
        handler = None
        if len(node.args) > pos:
            handler = node.args[pos]
        else:
            for kw in node.keywords:
                if kw.arg == kw_name:
                    handler = kw.value
        if handler is None:
            continue
        if isinstance(handler, ast.Lambda):
            hits = [
                (n.lineno, n.func.attr)
                for n in ast.walk(handler)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _STATE_TRANSITION_CALLS
            ]
            name = "<lambda>"
        else:
            if isinstance(handler, ast.Attribute):
                name = handler.attr
            elif isinstance(handler, ast.Name):
                name = handler.id
            else:
                continue
            fn = funcs.get(name)
            # follow local aliases (`decode = self._decode_x`) until a
            # definition resolves — bounded by the alias map size
            seen_aliases: set[str] = set()
            while fn is None and name in aliases and name not in seen_aliases:
                seen_aliases.add(name)
                name = aliases[name]
                fn = funcs.get(name)
            if fn is None:
                continue
            hits = _scan_handler(fn, funcs, set())
        for line, call in hits:
            out.append(
                Violation(
                    path,
                    node.lineno,
                    "queue-discipline",
                    f"gossip {kw_name} `{name}` reaches `{call}` "
                    f"(line {line}) on the socket reader thread — route "
                    f"state-transition work through BeaconProcessor.submit "
                    f"(subscribe_queued's process step)",
                )
            )
    return out


# ---------------------------------------------------------------------------
# Rule: metric-hygiene
# ---------------------------------------------------------------------------


def _is_registry_receiver(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id in ("REGISTRY", "registry")
    if isinstance(node, ast.Attribute):
        return node.attr in ("REGISTRY", "registry")
    return False


def _check_metric_hygiene(tree: ast.Module, path: str) -> list[Violation]:
    """Span/metric names must be string literals or module-level
    constants: a runtime-dynamic name (f-string, local, attribute) mints
    an unbounded family of histogram series in the registry AND an
    unbounded `tracing._last_logged` rate-limit map — series-cardinality
    explosion, the classic Prometheus foot-gun."""
    out: list[Violation] = []

    # names bindable at module scope: assignments and imports both count
    # as "module-level constant" (shared NAME constants are often
    # imported from the module that registers the series)
    consts: set[str] = set()
    for n in tree.body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    consts.add(t.id)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            consts.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for alias in n.names:
                consts.add((alias.asname or alias.name).split(".")[0])

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in _METRIC_NAME_CALLS:
            helper = f.id
        elif (
            isinstance(f, ast.Attribute)
            and f.attr in _REGISTRY_METHODS
            and _is_registry_receiver(f.value)
        ):
            helper = f"REGISTRY.{f.attr}"
        else:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            continue
        if isinstance(arg, ast.Name) and arg.id in consts:
            continue
        what = (
            "an f-string"
            if isinstance(arg, ast.JoinedStr)
            else type(arg).__name__
        )
        out.append(
            Violation(
                path,
                getattr(arg, "lineno", node.lineno),
                "metric-hygiene",
                f"dynamic metric/span name ({what}) passed to {helper}() — "
                f"use a string literal or a module-level constant; dynamic "
                f"names explode series cardinality and grow "
                f"tracing._last_logged unboundedly",
            )
        )
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

_CHECKS = (
    _check_safe_arith,
    _check_cow_aliasing,
    _check_fork_safety,
    _check_dirty_channel,
    _check_metric_hygiene,
    _check_queue_discipline,
)


def lint_source(source: str, path: str) -> list[Violation]:
    """Lint one file's source. Returns unsuppressed violations only
    (plus malformed-suppression findings)."""
    sup = _Suppressions(source, path)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "parse", str(e.msg))]
    raw: list[Violation] = []
    for check in _CHECKS:
        raw.extend(check(tree, path))
    out = [v for v in raw if not sup.allows(v.rule, v.line)]
    out.extend(sup.malformed)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def lint_paths(paths) -> list[Violation]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        else:
            files.append(p)
    out: list[Violation] = []
    for f in files:
        out.extend(lint_source(f.read_text(), str(f)))
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m lighthouse_tpu_torch.analysis",
        description="beacon-san: tree-states protocol linter",
    )
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule names and exit"
    )
    args = parser.parse_args(argv)
    if args.list_rules:
        print("\n".join(RULES))
        return 0
    violations = lint_paths(args.paths)
    for v in violations:
        print(v.render())
    if violations:
        print(f"{len(violations)} unsuppressed violation(s)")
        return 1
    return 0
