"""Beacon API HTTP client (common/eth2 analog).

The client side of http_api, used by the HTTP-backed validator client,
checkpoint sync, and tooling. JSON for queries, SSZ for states/blocks
(Accept/Content-Type: application/octet-stream), matching the reference's
`BeaconNodeHttpClient` surface (common/eth2/src/lib.rs)."""

from __future__ import annotations

import json
import urllib.error
import urllib.request


class ApiClientError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


class BeaconNodeHttpClient:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing -------------------------------------------------------------

    def _get(self, path: str, ssz: bool = False):
        req = urllib.request.Request(self.base + path)
        if ssz:
            req.add_header("Accept", "application/octet-stream")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                data = resp.read()
                if ssz or "json" not in resp.headers.get("Content-Type", ""):
                    return data
                return json.loads(data)
        except urllib.error.HTTPError as e:
            raise ApiClientError(e.code, e.read().decode(errors="replace")) from e

    def _post(self, path: str, body: bytes, content_type: str):
        req = urllib.request.Request(
            self.base + path,
            data=body,
            headers={"Content-Type": content_type},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            raise ApiClientError(e.code, e.read().decode(errors="replace")) from e

    # -- node -----------------------------------------------------------------

    def get_health(self) -> bool:
        try:
            self._get("/eth/v1/node/health")
            return True
        except (ApiClientError, OSError):
            return False

    def get_version(self) -> str:
        return self._get("/eth/v1/node/version")["data"]["version"]

    def get_syncing(self) -> dict:
        return self._get("/eth/v1/node/syncing")["data"]

    # -- beacon ----------------------------------------------------------------

    def get_genesis(self) -> dict:
        return self._get("/eth/v1/beacon/genesis")["data"]

    def get_state_root(self, state_id: str = "head") -> bytes:
        data = self._get(f"/eth/v1/beacon/states/{state_id}/root")["data"]
        return bytes.fromhex(data["root"].removeprefix("0x"))

    def get_finality_checkpoints(self, state_id: str = "head") -> dict:
        return self._get(
            f"/eth/v1/beacon/states/{state_id}/finality_checkpoints"
        )["data"]

    def get_state_ssz(self, state_id: str = "head") -> bytes:
        return self._get(f"/eth/v2/debug/beacon/states/{state_id}", ssz=True)

    def get_block_ssz(self, block_id: str = "head") -> bytes:
        return self._get(f"/eth/v2/beacon/blocks/{block_id}", ssz=True)

    def get_proposer_duties(self, epoch: int) -> list[dict]:
        return self._get(f"/eth/v1/validator/duties/proposer/{epoch}")["data"]

    def get_block_rewards(self, block_id: str) -> dict:
        return self._get(f"/eth/v1/beacon/rewards/blocks/{block_id}")["data"]

    # -- validator -------------------------------------------------------------

    def produce_block_ssz(self, slot: int, randao_reveal: bytes) -> bytes:
        return self._get(
            f"/eth/v3/validator/blocks/{slot}?randao_reveal=0x{randao_reveal.hex()}",
            ssz=True,
        )

    def publish_block_ssz(self, data: bytes) -> int:
        return self._post(
            "/eth/v1/beacon/blocks", data, "application/octet-stream"
        )

    def publish_attestations_ssz(self, data: bytes) -> int:
        return self._post(
            "/eth/v1/beacon/pool/attestations", data, "application/octet-stream"
        )

    def publish_sync_committee_messages_ssz(self, data: bytes) -> int:
        return self._post(
            "/eth/v1/beacon/pool/sync_committees",
            data,
            "application/octet-stream",
        )

    def get_aggregate_attestation_ssz(self, slot: int, data_root: bytes) -> bytes:
        return self._get(
            "/eth/v1/validator/aggregate_attestation"
            f"?slot={int(slot)}&attestation_data_root=0x{bytes(data_root).hex()}",
            ssz=True,
        )

    def publish_aggregate_and_proofs_ssz(self, data: bytes) -> int:
        return self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            data,
            "application/octet-stream",
        )

    def prepare_beacon_proposer(self, preparations: list[dict]) -> int:
        import json as _json

        return self._post(
            "/eth/v1/validator/prepare_beacon_proposer",
            _json.dumps(preparations).encode(),
            "application/json",
        )


class HttpBeaconNode:
    """validator_client BeaconNodeInterface over HTTP — the VC's real
    transport (the LocalBeaconNode stand-in talks to the chain object
    directly)."""

    def __init__(self, client: BeaconNodeHttpClient, types):
        self.client = client
        self.types = types

    def head_state(self):
        data = self.client.get_state_ssz("head")
        return self.types.decode_by_fork("BeaconState", data)

    def head_root(self):
        data = self._header_root()
        return data

    def _header_root(self):
        blk = self.client._get("/eth/v1/beacon/headers/head")
        return bytes.fromhex(blk["data"]["root"].removeprefix("0x"))

    def publish_block(self, signed_block):
        self.client.publish_block_ssz(signed_block.serialize())
        return signed_block.message.hash_tree_root()

    def publish_attestations(self, attestations):
        from ..ssz.core import List as SszList

        t = self.types
        data = SszList[t.Attestation, 1024].serialize_value(list(attestations))
        return self.client.publish_attestations_ssz(data)

    def produce_block(self, slot: int, randao_reveal: bytes):
        data = self.client.produce_block_ssz(slot, randao_reveal)
        return self.types.decode_by_fork("BeaconBlock", data)

    def publish_sync_committee_messages(self, messages):
        from ..ssz.core import List as SszList

        t = self.types
        data = SszList[t.SyncCommitteeMessage, 1024].serialize_value(
            list(messages)
        )
        return self.client.publish_sync_committee_messages_ssz(data)

    def get_aggregate(self, data):
        try:
            raw = self.client.get_aggregate_attestation_ssz(
                int(data.slot), data.hash_tree_root()
            )
        except ApiClientError as e:
            if e.code == 404:
                return None
            raise
        return self.types.Attestation.deserialize(raw)

    def publish_aggregates(self, signed_aggregates):
        """Returns a per-item result list like LocalBeaconNode (HTTP gives
        one batch status; a 2xx means the batch was accepted)."""
        from ..ssz.core import List as SszList

        t = self.types
        aggs = list(signed_aggregates)
        data = SszList[t.SignedAggregateAndProof, 1024].serialize_value(aggs)
        self.client.publish_aggregate_and_proofs_ssz(data)
        return [None] * len(aggs)

    def prepare_proposers(self, preparations: dict[int, bytes]):
        return self.client.prepare_beacon_proposer(
            [
                {
                    "validator_index": str(vi),
                    "fee_recipient": "0x" + bytes(fr).hex(),
                }
                for vi, fr in preparations.items()
            ]
        )
