"""Per-slot data-availability sampling (EIP-7594 peer sampling).

A node custodies CUSTODY_REQUIREMENT columns and, per block, samples
SAMPLES_PER_SLOT random NON-custody columns from peers. All samples
returned and verified → the block is treated as available (probabilistic
guarantee: a proposer withholding fraction f of columns survives one
node's sampling with probability (1-f)^samples, and survives the whole
honest set's sampling essentially never). The sample selection is
deterministic per (node_id, block_root) so verdicts are reproducible in
tests and across restarts — the spec randomizes per slot, but a
deterministic-from-root choice has the same withholding-detection power
against a proposer who must commit to the withheld set before the root
circulates.
"""

from __future__ import annotations

import hashlib

from ..metrics import inc_counter
from .custody import custody_columns


class SamplingEngine:
    """Selects and adjudicates per-block column samples.

    The engine is transport-agnostic: `sample` takes a `fetch(column)`
    callable (the network layer's by-root column request, already
    KZG-verified) and returns the verdict plus whatever was fetched so
    the caller can feed the sidecars into the availability checker."""

    def __init__(self, node_id: bytes, E, custody=None):
        self.E = E
        self.node_id = bytes(node_id)
        self.custody = (
            tuple(custody)
            if custody is not None
            else custody_columns(
                self.node_id, E.CUSTODY_REQUIREMENT, E.NUMBER_OF_COLUMNS
            )
        )

    def select_samples(self, block_root: bytes) -> tuple:
        """SAMPLES_PER_SLOT distinct non-custody columns, deterministic
        per (node_id, block_root)."""
        custody = set(self.custody)
        candidates = [
            c for c in range(self.E.NUMBER_OF_COLUMNS) if c not in custody
        ]
        if not candidates:
            return ()
        want = min(self.E.SAMPLES_PER_SLOT, len(candidates))
        out: list[int] = []
        i = 0
        while len(out) < want:
            h = hashlib.sha256(
                self.node_id + bytes(block_root) + i.to_bytes(8, "little")
            ).digest()
            col = candidates[int.from_bytes(h[:8], "little") % len(candidates)]
            if col not in out:
                out.append(col)
            i += 1
        return tuple(sorted(out))

    def sample(self, block_root: bytes, have, fetch) -> tuple:
        """(verdict, fetched_sidecars): query every selected column not in
        `have` via `fetch`; verdict is True iff every sample was served.
        All samples are attempted even after a miss — the extra columns
        still count toward reconstruction."""
        fetched = []
        ok = True
        for col in self.select_samples(block_root):
            if col in have:
                continue
            sidecar = fetch(col)
            if sidecar is None:
                ok = False
            else:
                fetched.append(sidecar)
        inc_counter(
            "das_sampling_results_total",
            1.0,
            verdict="success" if ok else "failure",
        )
        return ok, fetched
