"""PeerDAS-style data-availability sampling (EIP-7594 analog).

Counterpart of lighthouse_tpu/das, copied as host math. The one change:
the reference shards cell proofs and the batched verifier's MSMs across
its host fork pool (parallel/host_pool); the port runs the same work units
inline, as the reference does at pool size 1 (the pool waits for the node
slice, where no forked child may touch CUDA). Cell proofs on a ceremony
setup go through `Kzg.compute_kzg_proof`, and so through the K8 and K9
kernels on the card.

The columnar DA subsystem: each blob's 4096 evaluations extend to 8192
over the doubled root-of-unity domain (erasure.py), the extended matrix
slices into NUMBER_OF_COLUMNS `DataColumnSidecar`s — one column of cells
across all of a block's blobs with per-cell KZG proofs (sidecar.py,
proofs.py) — nodes custody a node-id-derived subset (custody.py) and
probabilistically sample the rest each slot (sampling.py), and any >=50%
of columns reconstructs the full matrix bit-exactly
(erasure.recover_extended). The batched cell verifier rides the
crypto/bls12_381 Pippenger MSM: a whole block's cells are one RLC pairing
check (`da_verify` trace root).

Availability policy lives in beacon_chain/data_availability.py. This
package is pure DA math + policy-free engines.

Metric series (eagerly registered):
  das_cells_verified_total{path=batched|oracle}
  das_sampling_results_total{verdict=success|failure}
  das_reconstructions_total
"""

from __future__ import annotations

from ..metrics import REGISTRY

_CELLS = REGISTRY.counter(
    "das_cells_verified_total",
    "data-column cells verified, by lane (batched RLC vs per-cell oracle)",
)
for _p in ("batched", "oracle"):
    _CELLS.inc(0.0, path=_p)
_SAMPLES = REGISTRY.counter(
    "das_sampling_results_total", "per-block column sampling verdicts"
)
for _v in ("success", "failure"):
    _SAMPLES.inc(0.0, verdict=_v)
REGISTRY.counter(
    "das_reconstructions_total",
    "full extended-matrix reconstructions from >=50% columns",
).inc(0.0)
# the batched verifier's stage spans (proofs.verify_cell_kzg_proof_batch)
# — registered at import so the series exist at zero before the first batch
for _stage in ("da_verify", "da_derive", "da_msm", "da_pairing"):
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the stage tuple above
        f"trace_span_seconds_{_stage}",
        f"span duration: {_stage}",
    )
del _CELLS, _SAMPLES, _p, _v, _stage

from .custody import column_subnet, custody_columns  # noqa: E402
from .erasure import (  # noqa: E402
    ErasureError,
    cells_from_extended,
    extend_evals,
    ext_roots_brp,
    recover_extended,
)
from .proofs import (  # noqa: E402
    DAS_BATCH_CHALLENGE_DOMAIN,
    DAS_CELL_PROOF_DOMAIN,
    cell_point_index,
    cell_to_fr,
    compute_cells_and_proofs,
    fr_to_cell,
    verify_cell_kzg_proof,
    verify_cell_kzg_proof_batch,
)
from .sampling import SamplingEngine  # noqa: E402
from .sidecar import (  # noqa: E402
    blobs_from_matrix,
    build_data_column_sidecars,
    recover_matrix,
    sidecar_cells,
    verify_data_column_sidecar,
    verify_data_column_sidecars,
)

__all__ = [
    "ErasureError",
    "SamplingEngine",
    "blobs_from_matrix",
    "recover_matrix",
    "DAS_BATCH_CHALLENGE_DOMAIN",
    "DAS_CELL_PROOF_DOMAIN",
    "build_data_column_sidecars",
    "cell_point_index",
    "cell_to_fr",
    "cells_from_extended",
    "column_subnet",
    "compute_cells_and_proofs",
    "custody_columns",
    "extend_evals",
    "ext_roots_brp",
    "fr_to_cell",
    "recover_extended",
    "sidecar_cells",
    "verify_cell_kzg_proof",
    "verify_cell_kzg_proof_batch",
    "verify_data_column_sidecar",
    "verify_data_column_sidecars",
]
