"""Beacon-node HTTP API (standard Ethereum Beacon API subset).

Counterpart of lighthouse_tpu/http_api/__init__.py, with the same routes
and bodies. The one addition: a forked serving worker lets a kernel
dispatch (`device.ForkedWorkerDispatch`) out of `_dispatch_get`, so that
it forwards the request to its parent (`workers.py`).

Mirrors beacon_node/http_api (src/lib.rs:1-6; 205 warp routes in the
reference): the eth/v1-v2 routes a validator client and operators need —
node status, genesis, state queries (root/fork/finality/validators),
headers/blocks, the attestation pool, duties, block production and
publication — served over the stdlib threading HTTP server (the warp
analog), plus the /metrics exposition of http_metrics (272 LoC crate).

Every uint64 is a JSON string and keys are snake_case per the API spec;
roots are 0x-hex. SSZ (`Accept: application/octet-stream`) is honored on
the block/state/validator_balances endpoints.

The read-heavy routes (validators / balances / committees / headers)
are a SERVING TIER: response bytes assembled zero-copy from the
resident RegistryColumns (`columnar.py`), cached per route keyed on
(head root, normalized query) with head-event invalidation
(`response_cache.py`), and headers/blocks indexed by root and slot
(`block_index.py`). The dict-returning per-object methods are retained
as byte-identical differential oracles."""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..device import ForkedWorkerDispatch
from ..metrics import REGISTRY, inc_counter
from ..metrics.server import serve_lighthouse_path
from ..utils.tracing import span
from ..state_processing.accessors import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_beacon_proposer_index,
)
from . import columnar
from .block_index import BlockHeaderIndex
from .columnar import QueryError, validator_status
from .response_cache import ResponseCache

#: every JSON body uses the compact separators — the columnar assembler
#: emits them directly, so the per-object oracle must serialize the same
#: way for the byte-identical differential to hold
_JSON_SEPARATORS = (",", ":")


def _dump_json(obj) -> bytes:
    return json.dumps(obj, separators=_JSON_SEPARATORS).encode()


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _container_json(value):
    """Generic SSZ container → beacon-API JSON (ints as strings, bytes as
    0x-hex, lists recursed)."""
    from ..ssz.core import Container

    if isinstance(value, Container):
        return {f: _container_json(getattr(value, f)) for f in value._fields}
    if isinstance(value, (bytes, bytearray, memoryview)):
        return _hex(bytes(value))
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return str(value)
    if isinstance(value, (list, tuple)):
        return [_container_json(v) for v in value]
    return value


def _validator_json(i: int, v, balance: int, status: str) -> dict:
    return {
        "index": str(i),
        "balance": str(balance),
        "status": status,
        "validator": {
            "pubkey": _hex(v.pubkey),
            "withdrawal_credentials": _hex(v.withdrawal_credentials),
            "effective_balance": str(v.effective_balance),
            "slashed": bool(v.slashed),
            "activation_eligibility_epoch": str(v.activation_eligibility_epoch),
            "activation_epoch": str(v.activation_epoch),
            "exit_epoch": str(v.exit_epoch),
            "withdrawable_epoch": str(v.withdrawable_epoch),
        },
    }


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        self.message = message


class BeaconApi:
    """Route implementations over a BeaconChain (transport-independent —
    the HTTP layer and tests call these directly)."""

    def __init__(self, chain, validator_client=None, network=None):
        self.chain = chain
        self.vc = validator_client
        self.network = network
        # genesis facts from chain invariants — never from the prunable
        # snapshot cache (the API may be constructed after finality)
        self._genesis_time = int(chain.head_state.genesis_time)
        self._genesis_validators_root = bytes(chain.genesis_validators_root)
        # the read-serving tier: per-route response caches keyed on
        # (head root, normalized query) + block-root-indexed header
        # lookups; the fork-choice head event (the one the SSE stream
        # consumes) invalidates, the block event keeps /headers honest
        # about fork blocks that don't move the head
        self.response_cache = ResponseCache()
        self.block_index = BlockHeaderIndex(chain)
        from ..beacon_chain.events import TOPIC_BLOCK, TOPIC_HEAD

        chain.event_handler.add_listener((TOPIC_HEAD,), self._on_head_event)
        chain.event_handler.add_listener((TOPIC_BLOCK,), self._on_block_event)

    def _on_head_event(self, _topic: str, data: dict):
        # entries for the new head, genesis, and the finalized root stay
        # (still valid AND still hot — a client polling /states/finalized
        # must not reassemble every slot); everything else is dead weight
        keep = {bytes.fromhex(data["block"][2:]), self.chain.genesis_block_root}
        cp = getattr(self.chain, "finalized_checkpoint", None)
        if cp is not None:
            keep.add(bytes(cp.root))
        self.response_cache.on_head_change(keep)

    def _on_block_event(self, _topic: str, _data: dict):
        self.response_cache.evict_route("headers")

    def close(self):
        """Detach from the chain's event handler (server shutdown — a
        replaced BeaconApi must not keep invalidating forever)."""
        self.chain.event_handler.remove_listener(self._on_head_event)
        self.chain.event_handler.remove_listener(self._on_block_event)

    # -- state resolution ----------------------------------------------------

    def _resolve_state(self, state_id: str):
        """(cache key root, state) for a StateId. The key root pins the
        response cache: a body derived from an immutable state never goes
        stale under its own (root, query) key."""
        chain = self.chain
        if state_id == "head":
            # read the root ONCE and resolve the state through it — a
            # concurrent head move between two reads would otherwise pair
            # the old root with the new state and poison the cache key
            root = chain.head_root
            st = chain._states.get(root)
            if st is None:
                root = chain.head_root
                st = chain.head_state
            return root, st
        if state_id == "genesis":
            st = chain._states.get(chain.genesis_block_root)
            if st is None:
                raise ApiError(
                    404, "genesis state pruned from the hot cache"
                )
            return chain.genesis_block_root, st
        if state_id == "finalized":
            cp = chain.finalized_checkpoint
            st = chain._justified_state_provider(cp.root)
            if st is None:
                raise ApiError(404, "finalized state unavailable")
            return bytes(cp.root), st
        if state_id.startswith("0x"):
            try:
                root = bytes.fromhex(state_id[2:])
            except ValueError as e:
                raise ApiError(400, f"invalid state id {state_id}") from e
            st = chain.store.get_state(root)
            if st is None:
                raise ApiError(404, f"state {state_id} not found")
            return root, st
        if state_id.isdigit():
            slot = int(state_id)
            st = chain.head_state
            if st.slot == slot:
                return chain.head_root, st
            raise ApiError(404, f"state at slot {slot} not in cache")
        raise ApiError(400, f"invalid state id {state_id}")

    def _state(self, state_id: str):
        return self._resolve_state(state_id)[1]

    def _columns_for(self, st):
        """The state's refreshed resident columns, or None when the
        state isn't in the tree-states representation (the per-object
        oracle path serves it instead)."""
        from ..state_processing.registry_columns import registry_columns_for

        cols = registry_columns_for(st)
        if cols is None or not cols.try_refresh(st):
            return None
        return cols

    def _block(self, block_id: str):
        chain = self.chain
        if block_id == "head":
            b = chain.head_block()
            if b is None:
                raise ApiError(404, "head block unavailable (genesis)")
            return chain.head_root, b
        if block_id.startswith("0x"):
            root = bytes.fromhex(block_id[2:])
            # hot set → bounded store-load LRU → ONE store deserialization
            b = self.block_index.block(root)
            if b is None:
                raise ApiError(404, f"block {block_id} not found")
            return root, b
        if block_id.isdigit():
            slot = int(block_id)
            roots = self.block_index.roots_at_slot(slot)
            if not roots:
                raise ApiError(404, f"block at slot {slot} not found")
            return roots[0], self.block_index.block(roots[0])
        raise ApiError(400, f"invalid block id {block_id}")

    # -- node ----------------------------------------------------------------

    def node_version(self):
        return {"data": {"version": "lighthouse-tpu/0.3.0"}}

    def node_health(self):
        return 200

    def node_identity(self):
        """GET /eth/v1/node/identity: this node's network identity (enr /
        peer id / listen addresses) when a network is attached."""
        net = self.network
        if net is None:
            return {
                "data": {
                    "peer_id": "", "enr": "", "p2p_addresses": [],
                    "discovery_addresses": [],
                    "metadata": {"seq_number": "0", "attnets": "0x00"},
                }
            }
        enr = (
            json.dumps(net.discovery.local_enr.to_dict())
            if net.discovery is not None
            else ""
        )
        return {
            "data": {
                "peer_id": f"127.0.0.1:{net.port}",
                "enr": enr,
                "p2p_addresses": [f"/ip4/127.0.0.1/tcp/{net.port}"],
                "discovery_addresses": (
                    [f"/ip4/127.0.0.1/udp/{net.discovery.udp_port}"]
                    if net.discovery is not None
                    else []
                ),
                "metadata": {
                    "seq_number": str(net.metadata_seq),
                    "attnets": "0x00",
                },
            }
        }

    def node_peers(self):
        """GET /eth/v1/node/peers."""
        net = self.network
        peers = net.peers.peers() if net is not None else []
        return {
            "data": [
                {
                    "peer_id": p.peer_id,
                    "state": "connected",
                    "direction": "outbound",
                    "last_seen_p2p_address": f"/ip4/{p.host}/tcp/{p.port}",
                    "score": p.score,
                }
                for p in peers
            ],
            "meta": {"count": len(peers)},
        }

    def node_syncing(self):
        head = self.chain.head_state.slot
        current = self.chain.slot_clock.now()
        return {
            "data": {
                "head_slot": str(head),
                "sync_distance": str(max(0, current - head)),
                "is_syncing": current > head + 1,
                "is_optimistic": False,
                "el_offline": self.chain.execution_layer is None,
            }
        }

    # -- beacon --------------------------------------------------------------

    def genesis(self):
        return {
            "data": {
                "genesis_time": str(self._genesis_time),
                "genesis_validators_root": _hex(self._genesis_validators_root),
                "genesis_fork_version": _hex(self.chain.spec.genesis_fork_version),
            }
        }

    def state_root(self, state_id: str):
        return {"data": {"root": _hex(self._state(state_id).hash_tree_root())}}

    def state_fork(self, state_id: str):
        f = self._state(state_id).fork
        return {
            "data": {
                "previous_version": _hex(f.previous_version),
                "current_version": _hex(f.current_version),
                "epoch": str(f.epoch),
            }
        }

    def finality_checkpoints(self, state_id: str):
        st = self._state(state_id)
        def cp(c):
            return {"epoch": str(c.epoch), "root": _hex(c.root)}
        return {
            "data": {
                "previous_justified": cp(st.previous_justified_checkpoint),
                "current_justified": cp(st.current_justified_checkpoint),
                "finalized": cp(st.finalized_checkpoint),
            }
        }

    # -- validators: the columnar serving tier -------------------------------
    #
    # `serve_*` methods build final response BYTES zero-copy from the
    # resident RegistryColumns through the per-route response cache (the
    # HTTP layer sends them verbatim). The dict-returning methods below
    # them are the RETAINED PER-OBJECT ORACLES: same shapes, same fixed
    # statuses, used by the differential tests — never on the hot path.

    def _parse_validator_query(self, st, cols, query):
        """Normalize a validators/balances request WITHOUT touching any
        full-table column: ids resolved once, statuses/pagination parsed
        into the cache-key form. Row selection (which may need a
        full-table status pass) happens only after a cache MISS."""
        query = query or {}
        n = len(st.balances)
        try:
            ids = query.get("id")
            id_idx = None
            if ids:
                if cols is not None:
                    resolver = lambda pk: cols.pubkey_index().get(pk)  # noqa: E731
                else:
                    # lazy: the O(n) oracle dict is built only if some
                    # id actually IS a pubkey (numeric-only filters on a
                    # column-less state stay O(k))
                    memo: list = []

                    def resolver(pk, _st=st, _memo=memo):
                        if not _memo:
                            _memo.append(self._oracle_pubkey_resolver(_st))
                        return _memo[0](pk)

                id_idx = columnar.normalize_ids(ids, resolver, n)
            statuses = query.get("status")
            status_filter = (
                columnar.normalize_statuses(statuses) if statuses else None
            )
            limit, offset = columnar.parse_pagination(query)
        except QueryError as e:
            raise ApiError(400, str(e)) from e
        qnorm = "&".join(
            p
            for p in (
                f"id={','.join(map(str, id_idx.tolist()))}"
                if id_idx is not None
                else "",
                f"status={','.join(map(str, sorted(status_filter)))}"
                if status_filter
                else "",
                f"limit={limit}" if limit is not None else "",
                f"offset={offset}" if offset else "",
            )
            if p
        )
        cacheable = id_idx is None  # id-filtered bodies churn per-VC
        return qnorm, id_idx, status_filter, limit, offset, cacheable

    def _select_validator_rows(self, st, cols, id_idx, status_filter,
                               limit, offset):
        """The post-miss row selection: full-table status codes are
        computed only when a status filter demands them — vectorized
        over the columns, or per-object when the state has none (the
        oracle path must filter too, not crash)."""
        n = len(st.balances)
        codes = None
        if status_filter is not None:
            cur = compute_epoch_at_slot(int(st.slot), self.chain.E)
            if cols is not None:
                codes = columnar.status_codes(
                    cols.activation_eligibility_epoch,
                    cols.activation_epoch,
                    cols.exit_epoch,
                    cols.withdrawable_epoch,
                    cols.slashed,
                    cols.balances,
                    cur,
                )
            else:
                import numpy as _np

                codes = _np.fromiter(
                    (
                        columnar.STATUSES.index(
                            validator_status(
                                int(v.activation_eligibility_epoch),
                                int(v.activation_epoch),
                                int(v.exit_epoch),
                                int(v.withdrawable_epoch),
                                bool(v.slashed),
                                int(st.balances[i]),
                                cur,
                            )
                        )
                        for i, v in enumerate(st.validators)
                    ),
                    dtype=_np.uint8,
                    count=n,
                )
        idx = columnar.select_rows(
            n, id_idx, status_filter, codes, limit, offset
        )
        return idx, codes

    def _oracle_pubkey_resolver(self, st):
        by_pk = {}
        for i in range(len(st.validators) - 1, -1, -1):
            by_pk[bytes(st.validators[i].pubkey)] = i
        return by_pk.get

    def _serve_cached(self, route, state_id, query, build, qnorm_suffix=""):
        """The shared cache-then-assemble path: cache_lookup / assemble /
        serialize trace stages under the api_request root. A cache hit
        pays only id/pagination normalization — never a full-table
        column pass."""
        root, st = self._resolve_state(state_id)
        cols = self._columns_for(st)
        qnorm, id_idx, status_filter, limit, offset, cacheable = (
            self._parse_validator_query(st, cols, query)
        )
        qnorm += qnorm_suffix
        with span("cache_lookup", route=route):
            hit = (
                self.response_cache.get(route, root, qnorm)
                if cacheable
                else None
            )
        if hit is not None:
            return hit
        idx, codes = self._select_validator_rows(
            st, cols, id_idx, status_filter, limit, offset
        )
        body, content_type = build(st, cols, idx, codes)
        if cacheable:
            self.response_cache.put(route, root, qnorm, body, content_type)
        return body, content_type

    def serve_state_validators(self, state_id: str, query=None):
        """GET /states/{id}/validators → (body bytes, content type),
        assembled zero-copy from the columns (per-object oracle fallback
        when the state has no resident columns)."""

        def build(st, cols, idx, codes):
            if cols is None:
                with span("assemble", route="validators"):
                    doc = self.state_validators_reference(
                        st, None if idx is None else idx.tolist()
                    )
                with span("serialize", route="validators"):
                    return _dump_json(doc), "application/json"
            body = columnar.assemble_validators(
                cols,
                cols.balances,
                idx,
                compute_epoch_at_slot(int(st.slot), self.chain.E),
                codes,
            )
            columnar.count_assembled("validators")
            return body, "application/json"

        return self._serve_cached("validators", state_id, query, build)

    def serve_state_validator_balances(self, state_id: str, query=None,
                                       ssz: bool = False):
        """GET /states/{id}/validator_balances → (body, content type).
        The SSZ variant (Accept: application/octet-stream) is fixed
        16-byte (index, balance) rows — one interleave, zero per-row
        Python."""

        def build(st, cols, idx, codes):
            if cols is None:
                with span("assemble", route="validator_balances"):
                    rows = (
                        range(len(st.balances))
                        if idx is None
                        else idx.tolist()
                    )
                    if ssz:
                        body = b"".join(
                            int(i).to_bytes(8, "little")
                            + int(st.balances[i]).to_bytes(8, "little")
                            for i in rows
                        )
                        return body, "application/octet-stream"
                    doc = self.state_validator_balances_reference(
                        st, None if idx is None else idx.tolist()
                    )
                with span("serialize", route="validator_balances"):
                    return _dump_json(doc), "application/json"
            if ssz:
                with span("assemble", route="validator_balances"):
                    body = columnar.balances_ssz(cols.balances, idx)
                columnar.count_assembled("validator_balances")
                return body, "application/octet-stream"
            body = columnar.assemble_balances(cols.balances, idx)
            columnar.count_assembled("validator_balances")
            return body, "application/json"

        return self._serve_cached(
            "validator_balances", state_id, query, build,
            qnorm_suffix="&ssz=1" if ssz else "",
        )

    def state_validator(self, state_id: str, validator_id: str):
        """GET /states/{id}/validators/{validator_id} (index or pubkey):
        a single-row column gather — by-pubkey resolves through the
        columns' pubkey→index map instead of the seed's O(n) scan."""
        st = self._state(state_id)
        cols = self._columns_for(st)
        n = len(st.balances)
        if validator_id.isdigit():
            i = int(validator_id)
            if i >= n:
                raise ApiError(404, "validator index out of range")
        else:
            try:
                pk = columnar._parse_pubkey(validator_id.lower())
            except QueryError as e:
                raise ApiError(400, str(e)) from e
            if cols is not None:
                got = cols.pubkey_index().get(pk)
            else:
                got = self._oracle_pubkey_resolver(st)(pk)
            if got is None:
                raise ApiError(404, "unknown validator pubkey")
            i = int(got)
        cur = compute_epoch_at_slot(int(st.slot), self.chain.E)
        v = st.validators[i]
        status = validator_status(
            int(v.activation_eligibility_epoch),
            int(v.activation_epoch),
            int(v.exit_epoch),
            int(v.withdrawable_epoch),
            bool(v.slashed),
            int(st.balances[i]),
            cur,
        )
        return {
            "data": _validator_json(i, v, int(st.balances[i]), status),
            "execution_optimistic": False,
            "finalized": False,
        }

    # -- per-object oracles (differential baselines) ---------------------------

    def state_validators_reference(self, st, indices=None):
        """The retained per-validator object walk (spec shapes, real
        statuses). `indices` is a pre-normalized int list or None."""
        cur = compute_epoch_at_slot(int(st.slot), self.chain.E)
        wanted = None if indices is None else set(indices)
        out = []
        for i, v in enumerate(st.validators):
            if wanted is not None and i not in wanted:
                continue
            bal = int(st.balances[i])
            out.append(
                _validator_json(
                    i,
                    v,
                    bal,
                    validator_status(
                        int(v.activation_eligibility_epoch),
                        int(v.activation_epoch),
                        int(v.exit_epoch),
                        int(v.withdrawable_epoch),
                        bool(v.slashed),
                        bal,
                        cur,
                    ),
                )
            )
        return {"data": out, "execution_optimistic": False, "finalized": False}

    def state_validators(self, state_id: str, indices=None):
        """Oracle entry by state id (ids normalized like the request
        path: ints, digit strings, or 0x-pubkeys)."""
        st = self._state(state_id)
        idx = None
        if indices:
            idx = columnar.normalize_ids(
                indices, self._oracle_pubkey_resolver(st), len(st.balances)
            ).tolist()
        return self.state_validators_reference(st, idx)

    def state_validator_balances_reference(self, st, indices=None):
        wanted = None if indices is None else set(indices)
        out = []
        for i in range(len(st.balances)):
            if wanted is not None and i not in wanted:
                continue
            out.append({"index": str(i), "balance": str(int(st.balances[i]))})
        return {"data": out, "execution_optimistic": False, "finalized": False}

    def state_validator_balances(self, state_id: str, indices=None):
        """GET /states/{id}/validator_balances (oracle entry)."""
        st = self._state(state_id)
        idx = None
        if indices:
            idx = columnar.normalize_ids(
                indices, self._oracle_pubkey_resolver(st), len(st.balances)
            ).tolist()
        return self.state_validator_balances_reference(st, idx)

    def state_randao(self, state_id: str, epoch=None):
        """GET /states/{id}/randao. Epochs outside the stored historical
        window are 400 (the vector would alias an unrelated mix)."""
        from ..state_processing.accessors import (
            get_current_epoch,
            get_randao_mix,
        )

        st = self._state(state_id)
        E = self.chain.E
        current = get_current_epoch(st, E)
        ep = int(epoch) if epoch is not None else current
        if not (current - E.EPOCHS_PER_HISTORICAL_VECTOR < ep <= current):
            raise ApiError(
                400,
                f"epoch {ep} outside the stored randao window "
                f"({max(0, current - E.EPOCHS_PER_HISTORICAL_VECTOR + 1)}"
                f"..{current})",
            )
        return {
            "data": {"randao": _hex(get_randao_mix(st, ep, E))},
            "execution_optimistic": False,
            "finalized": False,
        }

    def node_peer_count(self):
        """GET /eth/v1/node/peer_count."""
        n = len(self.network.peers.peers()) if self.network else 0
        return {
            "data": {
                "disconnected": "0",
                "connecting": "0",
                "connected": str(n),
                "disconnecting": "0",
            }
        }

    def pool_proposer_slashings(self):
        pool = self.chain.op_pool
        return {
            "data": [
                _container_json(s)
                for s in list(pool._proposer_slashings.values())
            ]
        }

    def pool_attester_slashings(self):
        pool = self.chain.op_pool
        return {
            "data": [_container_json(s) for s in list(pool._attester_slashings)]
        }

    def publish_proposer_slashing_ssz(self, data: bytes) -> int:
        """POST /eth/v1/beacon/pool/proposer_slashings (SSZ body)."""
        t = self.chain.types
        try:
            slashing = t.ProposerSlashing.deserialize(data)
            self.chain.process_proposer_slashing(slashing)
        except Exception as e:  # noqa: BLE001 — bad request, not node fault
            raise ApiError(400, f"invalid proposer slashing: {e}") from e
        if self.network is not None:
            self.network.publish_proposer_slashing(slashing)
        return 200

    def publish_attester_slashing_ssz(self, data: bytes) -> int:
        """POST /eth/v1/beacon/pool/attester_slashings (SSZ body)."""
        t = self.chain.types
        try:
            slashing = t.AttesterSlashing.deserialize(data)
            self.chain.process_attester_slashing(slashing)
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"invalid attester slashing: {e}") from e
        if self.network is not None:
            self.network.publish_attester_slashing(slashing)
        return 200

    def block_rewards(self, block_id: str):
        """GET /eth/v1/beacon/rewards/blocks/{block_id} — per-component
        proposer rewards via staged replay (rewards.py)."""
        from ..beacon_chain.rewards import compute_block_rewards

        root, signed = self._block(block_id)
        chain = self.chain
        parent_state = chain.state_for_block_root(
            bytes(signed.message.parent_root)
        )
        if parent_state is None:
            raise ApiError(404, "parent state unavailable for reward replay")
        try:
            data = compute_block_rewards(
                signed, parent_state, chain.spec, chain.E, chain.types
            )
        except ValueError as e:
            raise ApiError(400, str(e)) from e
        return {
            "data": data,
            "execution_optimistic": False,
            "finalized": False,
        }

    def _resolve_validator_ids(self, state, validator_ids) -> set[str]:
        """Spec ValidatorId = index | pubkey → set of index strings."""
        wanted = set()
        by_pubkey = None
        for v in validator_ids:
            v = str(v)
            if v.isdigit():
                wanted.add(v)
                continue
            if by_pubkey is None:
                by_pubkey = {
                    _hex(val.pubkey): str(i)
                    for i, val in enumerate(state.validators)
                }
            idx = by_pubkey.get(v.lower())
            if idx is not None:
                wanted.add(idx)
        return wanted

    def attestation_rewards(self, epoch: int, validator_ids=None):
        """POST /eth/v1/beacon/rewards/attestations/{epoch}: per-validator
        flag/inactivity deltas for attestations made in `epoch`, computed
        from the canonical state at the end of epoch+1 (before the epoch
        transition applies them)."""
        from ..beacon_chain.rewards import compute_attestation_rewards
        from ..state_processing import per_slot_processing

        chain = self.chain
        E = chain.E
        epoch = int(epoch)
        target_slot = (epoch + 2) * E.SLOTS_PER_EPOCH - 1
        if target_slot > int(chain.head_state.slot):
            raise ApiError(
                404, f"rewards for epoch {epoch} not yet computable"
            )
        anc = chain.fork_choice.proto.proto_array.ancestor_at_slot(
            chain.head_root, target_slot
        )
        if anc is None:
            raise ApiError(404, "canonical ancestor unavailable")
        st = chain.state_for_block_root(anc)
        if st is None:
            raise ApiError(404, "state unavailable for reward computation")
        st = st.copy()
        while st.slot < target_slot:
            per_slot_processing(st, chain.spec, E)
        fork = chain.types.fork_of_state(st)
        from ..types.chain_spec import ForkName

        if fork < ForkName.ALTAIR:
            raise ApiError(400, "attestation rewards are Altair+")
        data = compute_attestation_rewards(st, chain.spec, E, fork)
        if validator_ids:
            wanted = self._resolve_validator_ids(st, validator_ids)
            data["total_rewards"] = [
                e
                for e in data["total_rewards"]
                if e["validator_index"] in wanted
            ]
        return {
            "data": data,
            "execution_optimistic": False,
            "finalized": False,
        }

    def sync_committee_rewards(self, block_id: str, validator_ids=None):
        """POST /eth/v1/beacon/rewards/sync_committee/{block_id}: per-
        validator sync rewards (negative for absent members)."""
        from ..beacon_chain.rewards import compute_sync_committee_rewards

        root, signed = self._block(block_id)
        chain = self.chain
        parent_state = chain.state_for_block_root(
            bytes(signed.message.parent_root)
        )
        if parent_state is None:
            raise ApiError(404, "parent state unavailable for reward replay")
        try:
            data = compute_sync_committee_rewards(
                signed, parent_state, chain.spec, chain.E, chain.types
            )
        except ValueError as e:
            raise ApiError(400, str(e)) from e
        if validator_ids:
            wanted = self._resolve_validator_ids(parent_state, validator_ids)
            data = [e for e in data if e["validator_index"] in wanted]
        return {
            "data": data,
            "execution_optimistic": False,
            "finalized": False,
        }

    def block_header(self, block_id: str):
        root, _signed = self._block(block_id)
        # precomputed in the block index: the body root is hashed once
        # per block, not once per request
        entry = self.block_index.header_entry(root)
        if entry is None:
            raise ApiError(404, f"block {block_id} not found")
        return {
            "data": {
                "root": _hex(root),
                "canonical": self._is_canonical(
                    root, int(entry["message"]["slot"])
                ),
                "header": entry,
            }
        }

    def block_ssz(self, block_id: str) -> bytes:
        _root, signed = self._block(block_id)
        return signed.serialize()

    def block_root(self, block_id: str):
        root, _ = self._block(block_id)
        return {"data": {"root": _hex(root)}}

    def debug_state_ssz(self, state_id: str) -> bytes:
        """/eth/v2/debug/beacon/states/{id} (SSZ) — what checkpoint sync
        and the HTTP-backed VC pull."""
        return self._state(state_id).serialize()

    def produce_block_ssz(self, slot: int, randao_reveal: bytes) -> bytes:
        return self._produce_block(slot, randao_reveal).serialize()

    def publish_attestations_ssz(self, data: bytes) -> int:
        """POST /eth/v1/beacon/pool/attestations with an SSZ-encoded
        Attestation list (the standard route takes JSON; SSZ here keeps
        the codec shared with gossip)."""
        t = self.chain.types
        from ..ssz.core import List as SszList

        atts = SszList[t.Attestation, 1024].deserialize(data)
        results = self.chain.process_attestation_batch(list(atts))
        failures = [r for r in results if isinstance(r, Exception)]
        inc_counter("http_api_attestations_received", amount=len(atts))
        if failures and len(failures) == len(atts):
            raise ApiError(400, f"all attestations rejected: {failures[0]}")
        if failures:
            # Beacon API partial-failure contract: the client must learn
            # which duties were dropped
            raise ApiError(
                202,
                f"{len(failures)}/{len(atts)} attestations rejected: "
                f"{failures[0]}",
            )
        return 200

    def light_client_bootstrap_ssz(self, block_root_hex: str) -> bytes:
        """GET /eth/v1/beacon/light_client/bootstrap/{block_root} (SSZ) —
        the light-client server surface (beacon API light_client routes;
        reference serves these from its light-client server cache)."""
        from ..light_client import create_bootstrap

        try:
            root = bytes.fromhex(block_root_hex.removeprefix("0x"))
        except ValueError as e:
            raise ApiError(400, f"bad block root: {e}") from e
        chain = self.chain
        state = chain.state_for_block_root(root)
        if state is None:
            raise ApiError(404, "no state for that block root")
        if getattr(state, "current_sync_committee", None) is None:
            raise ApiError(404, "pre-Altair state has no light-client data")
        fork = chain.types.fork_of_state(state)
        return create_bootstrap(state, chain.E).serialize(), fork.value

    def light_client_update_ssz(self) -> tuple[bytes, str]:
        """GET /eth/v1/beacon/light_client/update (SSZ): the latest
        update — the head block's sync aggregate attesting its parent.
        Returns (ssz_bytes, consensus_version)."""
        from ..light_client import create_update

        chain = self.chain
        head_block = chain.head_block()
        if head_block is None:
            raise ApiError(404, "no head block")
        aggregate = getattr(head_block.message.body, "sync_aggregate", None)
        if aggregate is None:
            raise ApiError(404, "pre-Altair head has no sync aggregate")
        attested_root = bytes(head_block.message.parent_root)
        attested_state = chain.state_for_block_root(attested_root)
        if attested_state is None:
            raise ApiError(404, "attested state unavailable")
        cp = attested_state.finalized_checkpoint
        finalized_state = None
        if bytes(cp.root) != b"\x00" * 32:
            finalized_state = chain.state_for_block_root(bytes(cp.root))
            if finalized_state is None:
                raise ApiError(404, "finalized state unavailable")
        update = create_update(
            attested_state,
            finalized_state,
            aggregate,
            int(head_block.message.slot),
            chain.E,
        )
        fork = chain.types.fork_of_state(attested_state)
        return update.serialize(), fork.value

    def get_aggregate_ssz(self, slot: int, data_root: bytes) -> bytes:
        """GET /eth/v1/validator/aggregate_attestation (SSZ body)."""
        agg = self.chain.op_pool.get_aggregate(data_root)
        if agg is None or int(agg.data.slot) != int(slot):
            raise ApiError(404, "no aggregate for that data root")
        t = self.chain.types
        return t.Attestation.serialize_value(agg)

    def publish_aggregates_ssz(self, data: bytes) -> int:
        """POST /eth/v1/validator/aggregate_and_proofs (SSZ list)."""
        t = self.chain.types
        from ..ssz.core import List as SszList

        aggs = SszList[t.SignedAggregateAndProof, 1024].deserialize(data)
        errors = []
        for agg in aggs:
            try:
                self.chain.process_aggregate(agg)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        if errors and len(errors) == len(aggs):
            raise ApiError(400, f"all aggregates rejected: {errors[0]}")
        return 200

    def publish_sync_messages_ssz(self, data: bytes) -> int:
        """POST /eth/v1/beacon/pool/sync_committees (SSZ list)."""
        t = self.chain.types
        from ..ssz.core import List as SszList

        msgs = SszList[t.SyncCommitteeMessage, 1024].deserialize(data)
        errors = []
        for msg in msgs:
            try:
                self.chain.process_sync_committee_message(msg)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        if errors and len(errors) == len(msgs):
            raise ApiError(400, f"all sync messages rejected: {errors[0]}")
        return 200

    def prepare_beacon_proposer(self, preparations: list[dict]) -> int:
        """POST /eth/v1/validator/prepare_beacon_proposer (JSON)."""
        try:
            prep = {}
            for p in preparations:
                recipient = bytes.fromhex(
                    p["fee_recipient"].removeprefix("0x")
                )
                if len(recipient) != 20:
                    raise ValueError(
                        f"fee_recipient must be 20 bytes, got {len(recipient)}"
                    )
                prep[int(p["validator_index"])] = recipient
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise ApiError(400, f"malformed preparation: {e}") from e
        self.chain.prepare_proposers(prep)
        return 200

    def publish_block_ssz(self, data: bytes) -> int:
        # Resolve the fork first (exact-roundtrip decode), THEN import
        # exactly once so a genuine rejection surfaces as itself and never
        # re-attempts under another fork.
        try:
            signed = self.chain.types.decode_by_fork("SignedBeaconBlock", data)
        except ValueError:
            raise ApiError(400, "block SSZ does not decode under any known fork")
        try:
            self.chain.process_block(signed)
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"block rejected: {e}")
        return 200

    # -- validator -----------------------------------------------------------

    # -- config routes ---------------------------------------------------

    def config_spec(self):
        """GET /eth/v1/config/spec: the runtime ChainSpec as the API's
        flat name/value map (config_and_preset.rs)."""
        import dataclasses

        spec = self.chain.spec
        out = {}
        for f in dataclasses.fields(spec):
            v = getattr(spec, f.name)
            key = f.name.upper()
            if isinstance(v, bytes):
                out[key] = _hex(v)
            elif isinstance(v, int):
                out[key] = str(v)
            elif v is not None:
                out[key] = str(v)
        return {"data": out}

    def config_deposit_contract(self):
        return {
            "data": {
                "chain_id": str(getattr(self.chain.spec, "deposit_chain_id", 1)),
                "address": _hex(self.chain.spec.deposit_contract_address),
            }
        }

    def config_fork_schedule(self):
        spec = self.chain.spec
        E = self.chain.E
        sched = []
        prev = spec.genesis_fork_version
        for name, ver_attr, epoch_attr in (
            ("phase0", "genesis_fork_version", None),
            ("altair", "altair_fork_version", "altair_fork_epoch"),
            ("bellatrix", "bellatrix_fork_version", "bellatrix_fork_epoch"),
            ("capella", "capella_fork_version", "capella_fork_epoch"),
            ("deneb", "deneb_fork_version", "deneb_fork_epoch"),
            ("electra", "electra_fork_version", "electra_fork_epoch"),
        ):
            ver = getattr(spec, ver_attr, None)
            epoch = 0 if epoch_attr is None else getattr(spec, epoch_attr, None)
            if ver is None or epoch is None:
                continue
            sched.append(
                {
                    "previous_version": _hex(prev),
                    "current_version": _hex(ver),
                    "epoch": str(epoch),
                }
            )
            prev = ver
        return {"data": sched}

    # -- committees / duties ---------------------------------------------

    def _committee_cache(self, st, epoch):
        from ..state_processing.accessors import committee_cache_at

        if epoch is None:
            epoch = compute_epoch_at_slot(st.slot, self.chain.E)
        try:
            epoch = int(epoch)
            cc = committee_cache_at(st, epoch, self.chain.E)
        except ValueError as e:
            raise ApiError(400, f"bad epoch: {e}") from e
        return epoch, cc

    def serve_state_committees(self, state_id: str, epoch=None):
        """GET /states/{id}/committees → (body, content type): every
        committee a zero-copy slice of the epoch's shuffled permutation,
        member lists converted in one C pass per committee."""
        route = "committees"
        root, st = self._resolve_state(state_id)
        epoch_n, cc = self._committee_cache(st, epoch)
        qnorm = f"epoch={epoch_n}"
        with span("cache_lookup", route=route):
            hit = self.response_cache.get(route, root, qnorm)
        if hit is not None:
            return hit
        start = compute_start_slot_at_epoch(epoch_n, self.chain.E)
        with span("assemble", route=route):
            text = columnar.assemble_committees(cc, start)
            columnar.count_assembled(route)
        with span("serialize", route=route):
            body = text.encode()
        self.response_cache.put(route, root, qnorm, body, "application/json")
        return body, "application/json"

    def state_committees(self, state_id: str, epoch=None):
        """GET /eth/v1/beacon/states/{id}/committees (per-object oracle:
        the differential suite pins the columnar body against it)."""
        st = self._state(state_id)
        epoch_n, cc = self._committee_cache(st, epoch)
        start = compute_start_slot_at_epoch(epoch_n, self.chain.E)
        out = []
        for slot in range(start, start + self.chain.E.SLOTS_PER_EPOCH):
            for index in range(cc.committees_per_slot):
                out.append(
                    {
                        "index": str(index),
                        "slot": str(slot),
                        "validators": [
                            str(v) for v in cc.committee(slot, index)
                        ],
                    }
                )
        return {"data": out}

    def serve_headers(self, query=None):
        """GET /eth/v1/beacon/headers (list form): `slot=` /
        `parent_root=` filters over the block-root index; default is the
        head slot's headers (spec). Cached keyed on the head root and
        evicted on EVERY block event — a fork block changes this listing
        without moving the head."""
        route = "headers"
        query = query or {}
        chain = self.chain
        slot_q = query.get("slot")
        parent_q = query.get("parent_root")
        if isinstance(slot_q, (list, tuple)):
            slot_q = slot_q[0]
        if isinstance(parent_q, (list, tuple)):
            parent_q = parent_q[0]
        if slot_q is not None and not str(slot_q).isdigit():
            raise ApiError(400, f"bad slot {slot_q!r}")
        if parent_q is not None:
            try:
                parent = bytes.fromhex(str(parent_q).removeprefix("0x"))
            except ValueError as e:
                raise ApiError(400, f"bad parent_root {parent_q!r}") from e
            if len(parent) != 32:
                raise ApiError(400, "parent_root must be 32 bytes")
        qnorm = f"slot={slot_q}&parent_root={parent_q}"
        # one root read + one generation snapshot: a block event racing
        # the build (evicting this route mid-assembly) must not let the
        # pre-block listing be re-cached as fresh — and the put must key
        # the SAME root the lookup used
        head_root = chain.head_root
        generation = self.response_cache.generation
        with span("cache_lookup", route=route):
            hit = self.response_cache.get(route, head_root, qnorm)
        if hit is not None:
            return hit
        index = self.block_index
        index.sync()
        if parent_q is not None:
            roots = index.roots_by_parent(parent)
            if slot_q is not None:
                at_slot = set(index.roots_at_slot(int(slot_q)))
                roots = [r for r in roots if r in at_slot]
        elif slot_q is not None:
            roots = index.roots_at_slot(int(slot_q))
        else:
            head = chain.head_block()
            roots = (
                index.roots_at_slot(int(head.message.slot))
                if head is not None
                else []
            )
        with span("assemble", route=route):
            data = []
            for r in roots:
                entry = index.header_entry(r)
                if entry is None:
                    continue
                data.append(
                    {
                        "root": _hex(r),
                        "canonical": self._is_canonical(
                            r, int(entry["message"]["slot"])
                        ),
                        "header": entry,
                    }
                )
            columnar.count_assembled(route)
        with span("serialize", route=route):
            body = _dump_json(
                {
                    "data": data,
                    "execution_optimistic": False,
                    "finalized": False,
                }
            )
        self.response_cache.put(
            route, head_root, qnorm, body, "application/json",
            if_generation=generation,
        )
        return body, "application/json"

    def _is_canonical(self, root: bytes, slot: int) -> bool:
        if root == self.chain.head_root:
            return True
        try:
            anc = self.chain.fork_choice.proto.proto_array.ancestor_at_slot(
                self.chain.head_root, slot
            )
        except Exception:  # noqa: BLE001 — pruned from proto-array
            return False
        return anc == root

    def attester_duties(self, epoch: int, indices: list[int]):
        """POST /eth/v1/validator/duties/attester/{epoch}.

        Resolved through the epoch duty table (inverse shuffling +
        searchsorted over committee starts): one vectorized lookup over
        the requested indices instead of the seed's walk over every
        committee member of the epoch. Output rows keep the scan order
        (slot, committee, position) the Beacon API tier always served."""
        from ..state_processing.accessors import epoch_duty_table

        chain = self.chain
        st = chain.head_state
        req = sorted({int(i) for i in indices})
        try:
            table = epoch_duty_table(st, int(epoch), chain.E)
        except ValueError as e:
            raise ApiError(400, f"epoch out of range: {e}") from e
        found, slots, cidx, pos, size = table.lookup(req)
        hit = [vi for vi, f in zip(req, found) if f]
        cps = table.committees_per_slot
        cols = self._columns_for(st)
        rows = sorted(
            zip(slots.tolist(), cidx.tolist(), pos.tolist(), size.tolist(), hit)
        )
        duties = []
        for slot, index, p, length, vi in rows:
            pk = (
                bytes(cols.pubkeys[vi])
                if cols is not None
                else bytes(st.validators[vi].pubkey)
            )
            duties.append(
                {
                    "pubkey": _hex(pk),
                    "validator_index": str(vi),
                    "committee_index": str(index),
                    "committee_length": str(length),
                    "committees_at_slot": str(cps),
                    "validator_committee_index": str(p),
                    "slot": str(slot),
                }
            )
        return {
            "data": duties,
            "dependent_root": _hex(self._dependent_root(st, int(epoch))),
        }

    def _dependent_root(self, st, epoch: int) -> bytes:
        """Beacon API attester dependent_root: the block root at the last
        slot BEFORE epoch-1 (where epoch's shuffling seed froze) — stable
        across the epoch, so VCs only re-fetch duties on a genuine reorg
        of that slot (NOT the ever-moving head root)."""
        from ..state_processing.accessors import get_block_root_at_slot

        if epoch < 2:
            return bytes(self.chain.genesis_block_root)
        anchor = compute_start_slot_at_epoch(epoch - 1, self.chain.E) - 1
        try:
            return get_block_root_at_slot(st, anchor, self.chain.E)
        except Exception:  # noqa: BLE001 — slot outside the roots window
            return bytes(self.chain.head_root)

    def sync_duties(self, epoch: int, indices: list[int]):
        """POST /eth/v1/validator/duties/sync/{epoch}: valid for the
        current and next sync-committee periods — an epoch past the
        period boundary answers from next_sync_committee (VCs pre-fetch
        next-period duties before rotation)."""
        st = self.chain.head_state
        E = self.chain.E
        period_epochs = E.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        current_period = compute_epoch_at_slot(st.slot, E) // period_epochs
        wanted_period = int(epoch) // period_epochs
        if wanted_period == current_period:
            committee = getattr(st, "current_sync_committee", None)
        elif wanted_period == current_period + 1:
            committee = getattr(st, "next_sync_committee", None)
        else:
            raise ApiError(
                400, f"epoch {epoch} outside the current/next sync periods"
            )
        if committee is None:
            return {"data": []}
        wanted = {int(i) for i in indices}
        by_pubkey: dict[bytes, list[int]] = {}
        for pos, pk in enumerate(committee.pubkeys):
            by_pubkey.setdefault(bytes(pk), []).append(pos)
        duties = []
        for vi in sorted(wanted):
            if vi >= len(st.validators):
                continue
            pk = bytes(st.validators[vi].pubkey)
            positions = by_pubkey.get(pk)
            if positions:
                duties.append(
                    {
                        "pubkey": _hex(pk),
                        "validator_index": str(vi),
                        "validator_sync_committee_indices": [
                            str(p) for p in positions
                        ],
                    }
                )
        return {"data": duties}

    # -- pools / blobs ---------------------------------------------------

    def pool_attestations(self):
        pool = self.chain.op_pool
        out = []

        def cp(c):
            return {"epoch": str(c.epoch), "root": _hex(c.root)}

        # snapshot: gossip/VC threads mutate the pool during this walk
        for bucket in list(pool._attestations.values()):
            for att in list(bucket.atts):
                bits_t = type(att)._fields["aggregation_bits"]
                out.append(
                    {
                        # the SSZ Bitlist codec (delimiter bit included) —
                        # never a hand-rolled bit pack
                        "aggregation_bits": _hex(
                            bits_t.serialize_value(att.aggregation_bits)
                        ),
                        "data": {
                            "slot": str(att.data.slot),
                            "index": str(att.data.index),
                            "beacon_block_root": _hex(att.data.beacon_block_root),
                            "source": cp(att.data.source),
                            "target": cp(att.data.target),
                        },
                        "signature": _hex(att.signature),
                    }
                )
        return {"data": out}

    def pool_voluntary_exits(self):
        return {
            "data": [
                {
                    "message": {
                        "epoch": str(ex.message.epoch),
                        "validator_index": str(ex.message.validator_index),
                    },
                    "signature": _hex(ex.signature),
                }
                for ex in list(self.chain.op_pool._voluntary_exits.values())
            ]
        }

    def _blob_sidecars_consistent(self, root: bytes) -> list:
        """Sidecar read with a store-generation guard: an empty result
        observed while a migration/prune batch was running underneath is
        re-read against the settled view, so a block that legitimately
        has sidecars never serves [] mid-batch."""
        store = self.chain.store
        gen = store.generation
        sidecars = store.get_blob_sidecars(root)
        if not sidecars and store.generation != gen:
            sidecars = store.get_blob_sidecars(root)
        return sidecars

    def blob_sidecars(self, block_id: str):
        """GET /eth/v1/beacon/blob_sidecars/{block_id} — JSON shape."""
        root, _signed = self._block(block_id)
        return {
            "data": [
                {
                    "index": str(sc.index),
                    "blob": _hex(sc.blob),
                    "kzg_commitment": _hex(sc.kzg_commitment),
                    "kzg_proof": _hex(sc.kzg_proof),
                }
                for sc in self._blob_sidecars_consistent(root)
            ]
        }

    def blob_sidecars_ssz(self, block_id: str) -> bytes:
        """Same route under Accept: application/octet-stream."""
        root, _signed = self._block(block_id)
        sidecars = self._blob_sidecars_consistent(root)
        t = self.chain.types
        from ..ssz.core import List as SszList

        limit = self.chain.E.MAX_BLOB_COMMITMENTS_PER_BLOCK
        return SszList[t.BlobSidecar, limit].serialize_value(sidecars)

    def publish_voluntary_exit_ssz(self, data: bytes) -> int:
        t = self.chain.types
        try:
            exit_ = t.SignedVoluntaryExit.deserialize(data)
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"malformed SignedVoluntaryExit SSZ: {e}") from e
        try:
            self.chain.process_voluntary_exit(exit_)
        except Exception as e:  # noqa: BLE001
            raise ApiError(400, f"exit rejected: {e}") from e
        return 200

    def proposer_duties(self, epoch: int):
        from ..state_processing import per_slot_processing

        chain = self.chain
        start = compute_start_slot_at_epoch(epoch, chain.E)
        # one state advanced to the epoch (if future); per-slot proposers
        # come from the slot-mixed seed, valid for the whole epoch
        st = chain.head_state
        if compute_epoch_at_slot(st.slot, chain.E) < epoch:
            st = st.copy()
            while st.slot < start:
                per_slot_processing(st, chain.spec, chain.E)
        duties = []
        for slot in range(start, start + chain.E.SLOTS_PER_EPOCH):
            proposer = get_beacon_proposer_index(st, chain.E, slot=slot)
            duties.append(
                {
                    "pubkey": _hex(st.validators[proposer].pubkey),
                    "validator_index": str(proposer),
                    "slot": str(slot),
                }
            )
        return {"data": duties, "dependent_root": _hex(chain.head_root)}

    def _produce_block(self, slot: int, randao_reveal: bytes):
        """The ONE production pipeline both renderings route through
        (validator.rs produce_block/produce_block_v3 share a common
        inner): the chain's proposer pipeline — get_proposer_head target
        choice, pre-advanced snapshot, columnar packing — so the SSZ and
        object routes can never drift apart."""
        block, _post = self.chain.produce_block_on_state(slot, randao_reveal)
        return block

    def produce_block(self, slot: int, randao_reveal: bytes):
        return self._produce_block(slot, randao_reveal)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

_ROUTES = [
    ("GET", r"^/eth/v1/node/version$", "node_version"),
    ("GET", r"^/eth/v1/node/syncing$", "node_syncing"),
    ("GET", r"^/eth/v1/node/identity$", "node_identity"),
    ("GET", r"^/eth/v1/node/peers$", "node_peers"),
    ("GET", r"^/eth/v1/beacon/genesis$", "genesis"),
    ("GET", r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/root$", "state_root"),
    ("GET", r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/fork$", "state_fork"),
    (
        "GET",
        r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/finality_checkpoints$",
        "finality_checkpoints",
    ),
    (
        "GET",
        r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/validators/(?P<validator_id>[^/]+)$",
        "state_validator",
    ),
    (
        "GET",
        r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/randao$",
        "state_randao",
    ),
    ("GET", r"^/eth/v1/node/peer_count$", "node_peer_count"),
    (
        "GET",
        r"^/eth/v1/beacon/pool/proposer_slashings$",
        "pool_proposer_slashings",
    ),
    (
        "GET",
        r"^/eth/v1/beacon/pool/attester_slashings$",
        "pool_attester_slashings",
    ),
    (
        "GET",
        r"^/eth/v1/beacon/rewards/blocks/(?P<block_id>[^/]+)$",
        "block_rewards",
    ),
    ("GET", r"^/eth/v1/beacon/headers/(?P<block_id>[^/]+)$", "block_header"),
    ("GET", r"^/eth/v1/beacon/blocks/(?P<block_id>[^/]+)/root$", "block_root"),
    ("GET", r"^/eth/v1/validator/duties/proposer/(?P<epoch>\d+)$", "proposer_duties"),
    ("GET", r"^/eth/v1/config/spec$", "config_spec"),
    ("GET", r"^/eth/v1/config/deposit_contract$", "config_deposit_contract"),
    ("GET", r"^/eth/v1/config/fork_schedule$", "config_fork_schedule"),
    ("GET", r"^/eth/v1/beacon/pool/attestations$", "pool_attestations"),
    ("GET", r"^/eth/v1/beacon/pool/voluntary_exits$", "pool_voluntary_exits"),
]


class _Handler(BaseHTTPRequestHandler):
    api: BeaconApi = None
    #: set on the parent's handler when a worker tier is running — its
    #: /metrics merges the per-process snapshots instead of exposing only
    #: this process's registry
    worker_pool = None

    def log_message(self, *args):  # quiet
        pass

    def _send_json(self, obj, code=200):
        body = _dump_json(obj)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(self, data: bytes, code=200, version: str | None = None,
                    content_type: str = "application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if version is not None:
            # beacon-API consensus-version header: SSZ consumers need the
            # fork to pick the right container family (e.g. Electra's
            # deeper light-client branches)
            self.send_header("Eth-Consensus-Version", version)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _note_forward_demand(self):
        """Serving-worker tier: a replica forwarding a read
        because it went generation-stale tags the request — that is the
        pool's demand signal to rotate replicas onto a fresh CoW
        snapshot. Only the parent (the forward target) ever sees the
        header on a pool-owning handler."""
        pool = self.worker_pool
        if pool is not None and self.headers.get("X-Api-Forward-Why") == "stale":
            pool.note_stale_forward()

    def do_GET(self):
        inc_counter("http_api_requests_total", method="GET")
        self._note_forward_demand()
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/eth/v1/node/health":
            self.send_response(200)
            self.end_headers()
            return
        if path == "/metrics":
            pool = self.worker_pool
            text = REGISTRY.expose() if pool is None else pool.merged_metrics()
            self._send_bytes(
                text.encode(),
                content_type="text/plain; version=0.0.4",
            )
            return
        served = serve_lighthouse_path(path, parsed.query, chain=self.api.chain)
        if served is not None:
            # observability READS (traces/profile/health) stay outside the
            # api_request span — fetching a trace must not push new
            # "api_request" trees into the ring, and profiling the
            # profile endpoint would only measure itself
            code, content_type, body = served
            self._send_bytes(body, code, content_type=content_type)
            return
        if path == "/eth/v1/events":
            # SSE stream: excluded from tracing — the span would stay
            # open (and the trace undelivered) for the stream's lifetime
            try:
                self._serve_events(parse_qs(parsed.query))
            except Exception as e:  # noqa: BLE001
                self._send_json({"code": 500, "message": str(e)}, 500)
            return
        # root span of the API serving tier: each request thread gets a
        # fresh contextvars context, so this is always a trace root
        with span("api_request", method="GET", path=path):
            self._dispatch_get(parsed, path)

    def _validator_query(self, parsed) -> dict:
        """Validators/balances query params: `id` and `status` accept
        both repeats and comma-separated lists (spec), `limit`/`offset`
        are the bounded-page extension."""
        q = parse_qs(parsed.query)
        out = {}
        for name in ("id", "status"):
            vals = [x for v in q.get(name, []) for x in v.split(",") if x]
            if vals:
                out[name] = vals
        for name in ("limit", "offset"):
            if name in q:
                out[name] = q[name][0]
        return out

    def _dispatch_get(self, parsed, path):
        try:
            m = re.match(r"^/eth/v2/beacon/blocks/(?P<block_id>[^/]+)$", path)
            if m:
                if "application/octet-stream" in self.headers.get("Accept", ""):
                    self._send_bytes(self.api.block_ssz(m.group("block_id")))
                else:
                    self._send_json(self.api.block_header(m.group("block_id")))
                return
            m = re.match(r"^/eth/v2/debug/beacon/states/(?P<state_id>[^/]+)$", path)
            if m:
                self._send_bytes(self.api.debug_state_ssz(m.group("state_id")))
                return
            m = re.match(
                r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/committees$", path
            )
            if m:
                q = parse_qs(parsed.query)
                epoch = q.get("epoch", [None])[0]
                body, ctype = self.api.serve_state_committees(
                    m.group("state_id"), epoch
                )
                self._send_bytes(body, content_type=ctype)
                return
            m = re.match(
                r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/validators$", path
            )
            if m:
                body, ctype = self.api.serve_state_validators(
                    m.group("state_id"), self._validator_query(parsed)
                )
                self._send_bytes(body, content_type=ctype)
                return
            m = re.match(
                r"^/eth/v1/beacon/states/(?P<state_id>[^/]+)/validator_balances$",
                path,
            )
            if m:
                body, ctype = self.api.serve_state_validator_balances(
                    m.group("state_id"),
                    self._validator_query(parsed),
                    ssz="application/octet-stream"
                    in self.headers.get("Accept", ""),
                )
                self._send_bytes(body, content_type=ctype)
                return
            if path == "/eth/v1/beacon/headers":
                body, ctype = self.api.serve_headers(parse_qs(parsed.query))
                self._send_bytes(body, content_type=ctype)
                return
            m = re.match(
                r"^/eth/v1/beacon/blob_sidecars/(?P<block_id>[^/]+)$", path
            )
            if m:
                if "application/octet-stream" in self.headers.get("Accept", ""):
                    self._send_bytes(
                        self.api.blob_sidecars_ssz(m.group("block_id"))
                    )
                else:
                    self._send_json(self.api.blob_sidecars(m.group("block_id")))
                return
            m = re.match(
                r"^/eth/v1/beacon/light_client/bootstrap/(?P<root>0x[0-9a-fA-F]+)$",
                path,
            )
            if m:
                data, version = self.api.light_client_bootstrap_ssz(
                    m.group("root")
                )
                self._send_bytes(data, version=version)
                return
            if path == "/eth/v1/beacon/light_client/update":
                data, version = self.api.light_client_update_ssz()
                self._send_bytes(data, version=version)
                return
            if path == "/eth/v1/validator/aggregate_attestation":
                q = parse_qs(parsed.query)
                try:
                    slot = int(q["slot"][0])
                    root = bytes.fromhex(
                        q["attestation_data_root"][0].removeprefix("0x")
                    )
                except (KeyError, ValueError, IndexError) as e:
                    raise ApiError(400, f"bad query params: {e}") from e
                self._send_bytes(self.api.get_aggregate_ssz(slot, root))
                return
            m = re.match(r"^/eth/v3/validator/blocks/(?P<slot>\d+)$", path)
            if m:
                q = parse_qs(parsed.query)
                reveal = bytes.fromhex(
                    q.get("randao_reveal", ["00" * 96])[0].removeprefix("0x")
                )
                self._send_bytes(
                    self.api.produce_block_ssz(int(m.group("slot")), reveal)
                )
                return
            for method, pattern, fn_name in _ROUTES:
                if method != "GET":
                    continue
                m = re.match(pattern, path)
                if m:
                    kwargs = {
                        k: (int(v) if v.isdigit() and k == "epoch" else v)
                        for k, v in m.groupdict().items()
                    }
                    if fn_name == "state_randao":
                        q = parse_qs(parsed.query)
                        ep = q.get("epoch", [None])[0]
                        if ep is not None and not ep.isdigit():
                            raise ApiError(400, f"bad epoch {ep!r}")
                        kwargs["epoch"] = int(ep) if ep is not None else None
                    self._send_json(getattr(self.api, fn_name)(**kwargs))
                    return
            raise ApiError(404, f"unknown route {path}")
        except ApiError as e:
            self._send_json({"code": e.code, "message": e.message}, e.code)
        except ForkedWorkerDispatch:
            raise  # a forked worker forwards the request (workers.py)
        except Exception as e:  # noqa: BLE001
            self._send_json({"code": 500, "message": str(e)}, 500)

    def _serve_events(self, query):
        """SSE stream (beacon_chain/src/events.rs + the reference's
        `events` warp route): subscribes to the chain's event handler for
        the requested topics and streams frames until the client hangs up
        (or `max_seconds`, a test convenience, elapses)."""
        import time as _time

        from ..beacon_chain.events import ALL_TOPICS

        topics = query.get("topics", [",".join(ALL_TOPICS)])[0].split(",")
        try:
            sub = self.api.chain.event_handler.subscribe(topics)
        except ValueError as e:
            self._send_json({"code": 400, "message": str(e)}, 400)
            return
        max_seconds = float(query.get("max_seconds", ["3600"])[0])
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        deadline = _time.monotonic() + max_seconds
        try:
            while _time.monotonic() < deadline:
                # frames arrive pre-serialized from the broadcast thread —
                # one json.dumps per event regardless of subscriber count
                frame = sub.poll_frame(timeout=0.25)
                if frame is None:
                    if sub.closed:
                        break  # evicted as a slow consumer
                    continue
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away
        finally:
            self.api.chain.event_handler.unsubscribe(sub)

    def do_POST(self):
        inc_counter("http_api_requests_total", method="POST")
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        path = urlparse(self.path).path
        with span("api_request", method="POST", path=path):
            self._dispatch_post(path, body)

    def _dispatch_post(self, path, body):
        try:
            if path == "/eth/v1/beacon/blocks":
                if "application/octet-stream" in self.headers.get(
                    "Content-Type", ""
                ):
                    code = self.api.publish_block_ssz(body)
                    self._send_json({"code": code, "message": "ok"}, code)
                    return
                raise ApiError(415, "JSON block publishing not supported; use SSZ")
            if path == "/eth/v1/beacon/pool/attestations":
                code = self.api.publish_attestations_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            if path == "/eth/v1/validator/aggregate_and_proofs":
                code = self.api.publish_aggregates_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            if path == "/eth/v1/beacon/pool/sync_committees":
                code = self.api.publish_sync_messages_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            if path == "/eth/v1/validator/prepare_beacon_proposer":
                code = self.api.prepare_beacon_proposer(json.loads(body))
                self._send_json({"code": code, "message": "ok"}, code)
                return
            if path == "/eth/v1/beacon/pool/voluntary_exits":
                if "application/json" in self.headers.get("Content-Type", ""):
                    raise ApiError(
                        415, "JSON exit publishing not supported; use SSZ"
                    )
                code = self.api.publish_voluntary_exit_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            m = re.match(
                r"^/eth/v1/beacon/rewards/sync_committee/(?P<block_id>[^/]+)$",
                path,
            )
            if m:
                ids = json.loads(body) if body else None
                self._send_json(
                    self.api.sync_committee_rewards(m.group("block_id"), ids)
                )
                return
            m = re.match(
                r"^/eth/v1/beacon/rewards/attestations/(?P<epoch>\d+)$", path
            )
            if m:
                ids = json.loads(body) if body else None
                self._send_json(
                    self.api.attestation_rewards(int(m.group("epoch")), ids)
                )
                return
            if path == "/eth/v1/beacon/pool/proposer_slashings":
                code = self.api.publish_proposer_slashing_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            if path == "/eth/v1/beacon/pool/attester_slashings":
                code = self.api.publish_attester_slashing_ssz(body)
                self._send_json({"code": code, "message": "ok"}, code)
                return
            m = re.match(
                r"^/eth/v1/validator/duties/(?P<kind>attester|sync)/(?P<epoch>\d+)$",
                path,
            )
            if m:
                indices = [int(i) for i in json.loads(body)]
                fn = (
                    self.api.attester_duties
                    if m.group("kind") == "attester"
                    else self.api.sync_duties
                )
                self._send_json(fn(int(m.group("epoch")), indices))
                return
            raise ApiError(404, f"unknown route {path}")
        except ApiError as e:
            self._send_json({"code": e.code, "message": e.message}, e.code)
        except Exception as e:  # noqa: BLE001
            self._send_json({"code": 500, "message": str(e)}, 500)


class HttpApiServer:
    """Threaded HTTP server bound to localhost (warp analog).

    `workers=0` (default) is the historical single-process server.
    `workers=N` builds the multi-process read-replica tier (see
    `workers.py`): the public port's socket is bound pre-fork and N
    worker processes accept on it, serving read-tier routes from their
    CoW-shared warm state; this parent keeps a private full server on
    `parent_port` that workers forward mutations, operator routes, SSE
    streams, and stale reads to."""

    def __init__(self, chain, port: int = 0, network=None, workers: int = 0):
        self.api = BeaconApi(chain, network=network)
        self.workers = max(0, int(workers))
        handler = type("BoundHandler", (_Handler,), {"api": self.api})
        self._pool = None
        self._public_sock = None
        if self.workers == 0:
            self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
            self.port = self._server.server_address[1]
        else:
            from .workers import ApiWorkerPool, bind_public_socket

            self._public_sock = bind_public_socket(port)
            self.port = self._public_sock.getsockname()[1]
            self._server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
            self.parent_port = self._server.server_address[1]
            self._pool = ApiWorkerPool(
                self.api, self._public_sock, self.workers, self.parent_port
            )
            handler.worker_pool = self._pool
        self._thread = None

    def start(self):
        from ..metrics.profiler import maybe_start_profiler

        maybe_start_profiler()  # no-op (and no thread) unless armed by env
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="http_api"
        )
        self._thread.start()
        if self._pool is not None:
            # fork AFTER the parent server (and whatever the caller warmed
            # through self.api) is live: CoW hands workers the columns,
            # indexes, and any primed response-cache entries for free
            self._pool.start()
        return self

    def stop(self):
        if self._pool is not None:
            self._pool.stop()
            self._pool = None
        self._server.shutdown()
        self._server.server_close()
        if self._public_sock is not None:
            self._public_sock.close()
            self._public_sock = None
        self.api.close()  # detach cache invalidation from the chain
