"""Block-sized state writes, each followed by ``BeaconState.hash_tree_root``.

The traffic file gives the writes of one block (balances, slashed records,
the participation share of one slot, that slot's roots and RANDAO mix, and
under Electra the deposit receipts and withdrawal requests). A step applies
one block's writes to the program's tree-states BeaconState and roots it,
ending in a synchronise; the window runs steps back to back. The rate is the
window over the steps; every step's time is kept for the tail.

``correct``: the roots of the cold state, of seeded steps and of the last step
against the reference's fold of the same state and writes
(``reference/state_root.py``), which hashes every leaf again with no cache.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Check, Outcome
from benchmark.inputs.state import apply_program, apply_raw, build_state, draw_writes, to_program
from benchmark.reference.state_root import ELECTRA_FIELDS, STATE_FIELDS, StateRooter
from benchmark.roofline import state_write_rows


def _pool(raw, traffic: dict, seed: int, steps: int) -> list:
    """The writes of `steps` consecutive blocks from the seed."""
    rng = np.random.default_rng([seed, 1])
    slot = raw.f["slot"]
    out = []
    for _ in range(steps):
        w = draw_writes(slot, raw.n, raw.preset, traffic, raw.fork, rng)
        out.append(w)
        slot = w.slot
    return out


def run(ctx, root_of=None, apply=apply_program) -> Outcome:
    """Set-up, warm-up, the window and the reference check. `root_of` and
    `apply` replace the step's root call and its writes (the benchmark's own
    tests plant faults and the control there); by default the program's
    ``hash_tree_root`` and its persistent lists' writes."""
    import torch

    from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
    from lighthouse_tpu_torch.types import MainnetEthSpec, build_types

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n = cfg["validators"]
    types = build_types(MainnetEthSpec)
    raw = build_state(
        cfg["preset"], cfg["fork"], n, ctx.seed,
        slot_in_epoch=None, pending=cfg.get("pending"), compounding_share=cfg.get("compounding_share", 0.0),
    )
    state = to_program(raw, types)
    _make_persistent(state)
    root_of = root_of or (lambda s: bytes(s.hash_tree_root()))
    roots = {"cold": root_of(state)}
    warm = tr["warmup_steps"]
    pool = _pool(raw, tr, ctx.seed, warm + max(1, int(ctx.seconds * tr["max_steps_per_s"])))
    for w in pool[:warm]:
        apply(state, w, types, raw.preset)
        root_of(state)
    torch.cuda.synchronize()

    ctx.setup_done()
    step_s = []
    step_roots = []
    with ctx.window():
        start = time.monotonic()
        deadline = start + ctx.seconds
        for w in pool[warm:]:
            t = time.monotonic()
            with ctx.label("writes"):
                apply(state, w, types, raw.preset)
            with ctx.label("hash_tree_root"):
                r = root_of(state)
                torch.cuda.synchronize()
            done = time.monotonic()
            step_s.append(done - t)
            step_roots.append(r)
            if done >= deadline:
                break
        end = time.monotonic()
    ctx.read_memory()
    del state
    ctx.free_device()

    steps = len(step_s)
    window_s = end - start
    # the reference: cold, two seeded steps of the window and its last
    rng = np.random.default_rng([ctx.seed, 2])
    picks = sorted({int(i) for i in rng.integers(0, steps, 2)} | {steps - 1})
    rooter = StateRooter("cuda" if torch.cuda.is_available() else "cpu")
    mismatched = int(rooter.root(raw) != roots["cold"])
    for w in pool[:warm]:
        apply_raw(raw, w)
    for k in range(picks[-1] + 1):
        apply_raw(raw, pool[warm + k])
        if k in picks:
            mismatched += int(rooter.root(raw) != step_roots[k])
    names = STATE_FIELDS + (ELECTRA_FIELDS if raw.fork == "electra" else ())
    field_index = {f: i for i, f in enumerate(names)}
    pending = {k: len(v) for k, v in raw.f.items() if k.startswith("pending_")}
    # the least-work count feeds only the traced run's roofline share
    least_rows = [state_write_rows(w, n, raw.fork, raw.preset, pending, field_index)
                  for w in pool[warm : warm + steps]] if ctx.traced else []
    return Outcome(
        attempted=steps,
        failed=0,
        e2e={"state_root_ms": window_s / steps * 1e3},
        checks=[Check("roots_differing", mismatched, 0)],
        work={"steps": steps, "window_s": window_s, "step_s": step_s, "least_rows": least_rows},
    )
