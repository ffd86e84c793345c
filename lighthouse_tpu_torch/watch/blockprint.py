"""Blockprint: client-fingerprint classification of proposals.

The reference's watch integrates with the external `blockprint` ML
service (watch/src/blockprint/) that guesses which consensus client
built each block and aggregates per-client proposal shares. With zero
egress, this module ships the in-process analog: a transparent
heuristic classifier over the block's observable fingerprints (graffiti
conventions and, post-merge, the execution payload's extra_data, which
builders/ELs stamp) feeding the same per-slot table + aggregate the
reference's `/v1/blocks/{slot}/blockprint` style queries expose.

The labels use the public client names; classification confidence is
honest — anything unrecognized is "Unknown" rather than a forced guess.
"""

from __future__ import annotations

# (label, lowercase graffiti/extra-data markers) — the well-known public
# self-identification conventions each client ships by default
_MARKERS = [
    # most-specific first: "lighthouse-tpu" must win over its substring
    ("LighthouseTPU", (b"lighthouse-tpu", b"lighthouse_tpu")),
    ("Lighthouse", (b"lighthouse",)),
    ("Prysm", (b"prysm",)),
    ("Teku", (b"teku",)),
    ("Nimbus", (b"nimbus",)),
    ("Lodestar", (b"lodestar",)),
    ("Grandine", (b"grandine",)),
]

# execution-layer extra_data stamps (geth/nethermind/besu/erigon/reth) —
# identify the EL, which watch records alongside the CL guess
_EL_MARKERS = [
    ("Geth", (b"geth",)),
    ("Nethermind", (b"nethermind",)),
    ("Besu", (b"besu",)),
    ("Erigon", (b"erigon",)),
    ("Reth", (b"reth",)),
]


def _scan(data: bytes, markers) -> str | None:
    low = bytes(data).lower()
    for label, needles in markers:
        if any(n in low for n in needles):
            return label
    return None


def classify_block(signed_block) -> dict:
    """Best-guess fingerprint for one signed beacon block.

    Returns {"best_guess": str, "el_guess": str | None, "graffiti": str}.
    """
    body = signed_block.message.body
    graffiti = bytes(signed_block.message.body.graffiti)
    guess = _scan(graffiti, _MARKERS)
    el_guess = None
    payload = getattr(body, "execution_payload", None)
    if payload is not None:
        el_guess = _scan(bytes(payload.extra_data), _EL_MARKERS)
        if guess is None:
            # some setups stamp the CL name into extra_data instead
            guess = _scan(bytes(payload.extra_data), _MARKERS)
    return {
        "best_guess": guess or "Unknown",
        "el_guess": el_guess,
        "graffiti": graffiti.rstrip(b"\x00").decode("utf-8", "replace"),
    }
