"""Engine-API over JSON-RPC/HTTP with JWT auth.

The execution_layer/src/engine_api/http.rs analog: `HttpEngineClient` is
an `ExecutionLayer` speaking engine_newPayload / engine_forkchoiceUpdated
/ engine_getPayload (V1-V4 chosen by fork) to an execution node's
authenticated port, refreshing its JWT per request (auth.rs). The
camelCase/0x-hex payload codec follows the execution-apis schema.

`MockEngineServer` is the reference MockServer analog
(test_utils/mod.rs:100): it serves ANY in-process `ExecutionLayer`
(normally the MockExecutionLayer) over the same wire protocol, validating
JWTs, so the HTTP client is exercised end-to-end without a real EL."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..types.chain_spec import ForkName
from ..utils.logging import get_logger
from . import (
    ExecutionLayer,
    ExecutionLayerError,
    ForkchoiceState,
    PayloadAttributes,
    PayloadStatusV1,
)
from .auth import JwtError, generate_jwt, validate_jwt

log = get_logger("engine_api")


class EngineTransportError(ExecutionLayerError):
    """The engine could not be reached (network-level failure)."""

_FORK_VERSION = {
    ForkName.BELLATRIX: 1,
    ForkName.CAPELLA: 2,
    ForkName.DENEB: 3,
    ForkName.ELECTRA: 4,
}


# -- JSON codec (execution-apis camelCase / 0x-hex) -------------------------


def _q(v: int) -> str:  # QUANTITY
    return hex(int(v))


def _d(b: bytes) -> str:  # DATA
    return "0x" + bytes(b).hex()


def _uq(s: str) -> int:
    return int(s, 16)


def _ud(s: str) -> bytes:
    return bytes.fromhex(s.removeprefix("0x"))


def payload_to_json(payload) -> dict:
    out = {
        "parentHash": _d(payload.parent_hash),
        "feeRecipient": _d(payload.fee_recipient),
        "stateRoot": _d(payload.state_root),
        "receiptsRoot": _d(payload.receipts_root),
        "logsBloom": _d(payload.logs_bloom),
        "prevRandao": _d(payload.prev_randao),
        "blockNumber": _q(payload.block_number),
        "gasLimit": _q(payload.gas_limit),
        "gasUsed": _q(payload.gas_used),
        "timestamp": _q(payload.timestamp),
        "extraData": _d(payload.extra_data),
        "baseFeePerGas": _q(payload.base_fee_per_gas),
        "blockHash": _d(payload.block_hash),
        "transactions": [_d(tx) for tx in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [
            {
                "index": _q(w.index),
                "validatorIndex": _q(w.validator_index),
                "address": _d(w.address),
                "amount": _q(w.amount),
            }
            for w in payload.withdrawals
        ]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = _q(payload.blob_gas_used)
        out["excessBlobGas"] = _q(payload.excess_blob_gas)
    if hasattr(payload, "deposit_receipts"):
        out["depositReceipts"] = [
            {
                "pubkey": _d(r.pubkey),
                "withdrawalCredentials": _d(r.withdrawal_credentials),
                "amount": _q(r.amount),
                "signature": _d(r.signature),
                "index": _q(r.index),
            }
            for r in payload.deposit_receipts
        ]
        out["withdrawalRequests"] = [
            {
                "sourceAddress": _d(w.source_address),
                "validatorPubkey": _d(w.validator_pubkey),
                "amount": _q(w.amount),
            }
            for w in payload.withdrawal_requests
        ]
    return out


def payload_from_json(doc: dict, types, fork: ForkName):
    cls = {
        ForkName.BELLATRIX: types.ExecutionPayload,
        ForkName.CAPELLA: types.ExecutionPayloadCapella,
        ForkName.DENEB: types.ExecutionPayloadDeneb,
        ForkName.ELECTRA: types.ExecutionPayloadElectra,
    }[fork]
    kwargs = dict(
        parent_hash=_ud(doc["parentHash"]),
        fee_recipient=_ud(doc["feeRecipient"]),
        state_root=_ud(doc["stateRoot"]),
        receipts_root=_ud(doc["receiptsRoot"]),
        logs_bloom=_ud(doc["logsBloom"]),
        prev_randao=_ud(doc["prevRandao"]),
        block_number=_uq(doc["blockNumber"]),
        gas_limit=_uq(doc["gasLimit"]),
        gas_used=_uq(doc["gasUsed"]),
        timestamp=_uq(doc["timestamp"]),
        extra_data=_ud(doc["extraData"]),
        base_fee_per_gas=_uq(doc["baseFeePerGas"]),
        block_hash=_ud(doc["blockHash"]),
        transactions=[_ud(tx) for tx in doc["transactions"]],
    )
    if fork >= ForkName.CAPELLA:
        kwargs["withdrawals"] = [
            types.Withdrawal(
                index=_uq(w["index"]),
                validator_index=_uq(w["validatorIndex"]),
                address=_ud(w["address"]),
                amount=_uq(w["amount"]),
            )
            for w in doc.get("withdrawals", [])
        ]
    if fork >= ForkName.DENEB:
        kwargs["blob_gas_used"] = _uq(doc.get("blobGasUsed", "0x0"))
        kwargs["excess_blob_gas"] = _uq(doc.get("excessBlobGas", "0x0"))
    if fork >= ForkName.ELECTRA:
        kwargs["deposit_receipts"] = [
            types.DepositReceipt(
                pubkey=_ud(r["pubkey"]),
                withdrawal_credentials=_ud(r["withdrawalCredentials"]),
                amount=_uq(r["amount"]),
                signature=_ud(r["signature"]),
                index=_uq(r["index"]),
            )
            for r in doc.get("depositReceipts", [])
        ]
        kwargs["withdrawal_requests"] = [
            types.ExecutionLayerWithdrawalRequest(
                source_address=_ud(w["sourceAddress"]),
                validator_pubkey=_ud(w["validatorPubkey"]),
                amount=_uq(w["amount"]),
            )
            for w in doc.get("withdrawalRequests", [])
        ]
    return cls(**kwargs)


def attributes_to_json(attributes: PayloadAttributes, fork: ForkName) -> dict:
    """Fork-shaped attributes: Bellatrix has no withdrawals field at all
    (a spec EL rejects V1 attributes carrying one); Deneb+ adds
    parentBeaconBlockRoot."""
    out = {
        "timestamp": _q(attributes.timestamp),
        "prevRandao": _d(attributes.prev_randao),
        "suggestedFeeRecipient": _d(attributes.suggested_fee_recipient),
    }
    if fork >= ForkName.CAPELLA:
        out["withdrawals"] = [
            {
                "index": _q(w.index),
                "validatorIndex": _q(w.validator_index),
                "address": _d(w.address),
                "amount": _q(w.amount),
            }
            for w in attributes.withdrawals or []
        ]
    if fork >= ForkName.DENEB:
        out["parentBeaconBlockRoot"] = _d(
            attributes.parent_beacon_block_root or b"\x00" * 32
        )
    return out


def attributes_from_json(doc: dict, types) -> PayloadAttributes:
    withdrawals = [
        types.Withdrawal(
            index=_uq(w["index"]),
            validator_index=_uq(w["validatorIndex"]),
            address=_ud(w["address"]),
            amount=_uq(w["amount"]),
        )
        for w in doc.get("withdrawals", [])
    ]
    pbbr = doc.get("parentBeaconBlockRoot")
    return PayloadAttributes(
        timestamp=_uq(doc["timestamp"]),
        prev_randao=_ud(doc["prevRandao"]),
        suggested_fee_recipient=_ud(doc["suggestedFeeRecipient"]),
        withdrawals=withdrawals,
        parent_beacon_block_root=_ud(pbbr) if pbbr else None,
    )


# -- client -----------------------------------------------------------------


class HttpEngineClient(ExecutionLayer):
    """JSON-RPC engine-API client (http.rs): each request carries a fresh
    JWT; JSON-RPC errors surface as ExecutionLayerError."""

    def __init__(self, url: str, jwt_secret: bytes, types, timeout: float = 10.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.types = types
        self.timeout = timeout
        self._id = 0
        # head context for get_payload's forkchoiceUpdated step
        self.forkchoice_state = ForkchoiceState(
            head_block_hash=b"\x00" * 32,
            safe_block_hash=b"\x00" * 32,
            finalized_block_hash=b"\x00" * 32,
        )

    def _call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {generate_jwt(self.jwt_secret)}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                doc = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # an HTTP error response (401 auth, 5xx) came from a LIVE
            # engine — application-level, must not flip the watchdog
            raise ExecutionLayerError(
                f"{method}: HTTP {e.code}: {e.read()[:200]!r}"
            ) from e
        except OSError as e:
            # transport distinct from application errors: only this kind
            # should flip the watchdog to OFFLINE
            raise EngineTransportError(f"{method}: transport error: {e}") from e
        if doc.get("error"):
            raise ExecutionLayerError(f"{method}: {doc['error']}")
        return doc["result"]

    # -- ExecutionLayer surface ------------------------------------------

    def notify_new_payload(self, request) -> PayloadStatusV1:
        payload = request.execution_payload
        fork = _fork_of_payload(payload, self.types)
        v = _FORK_VERSION[fork]
        params = [payload_to_json(payload)]
        if v >= 3:
            params.append(
                [_d(h) for h in getattr(request, "versioned_hashes", []) or []]
            )
            params.append(
                _d(getattr(request, "parent_beacon_block_root", b"\x00" * 32))
            )
        result = self._call(f"engine_newPayloadV{min(v, 4)}", params)
        return PayloadStatusV1(result["status"])

    def notify_forkchoice_updated(
        self, forkchoice_state, attributes, fork: ForkName = ForkName.CAPELLA
    ):
        self.forkchoice_state = forkchoice_state
        # fcU version tracks the attributes shape: V2 through capella,
        # V3 for deneb+ (parentBeaconBlockRoot)
        v = 3 if fork >= ForkName.DENEB else 2
        params = [
            {
                "headBlockHash": _d(forkchoice_state.head_block_hash),
                "safeBlockHash": _d(forkchoice_state.safe_block_hash),
                "finalizedBlockHash": _d(forkchoice_state.finalized_block_hash),
            },
            attributes_to_json(attributes, fork) if attributes else None,
        ]
        result = self._call(f"engine_forkchoiceUpdatedV{v}", params)
        self._last_payload_id = result.get("payloadId")
        return PayloadStatusV1(result["payloadStatus"]["status"])

    def get_payload(self, parent_hash, attributes: PayloadAttributes, fork):
        v = _FORK_VERSION.get(fork, 4)
        if parent_hash is not None:
            head = bytes(parent_hash)
        else:
            # merge-transition production: build on the EL's latest
            # (terminal) block — resolved over eth_getBlockByNumber, the
            # same way a CL locates the terminal block
            latest = self._call("eth_getBlockByNumber", ["latest", False])
            if latest is None:
                raise ExecutionLayerError("engine has no latest block")
            head = _ud(latest["hash"])
        fc = ForkchoiceState(
            head_block_hash=head,
            safe_block_hash=self.forkchoice_state.safe_block_hash,
            finalized_block_hash=self.forkchoice_state.finalized_block_hash,
        )
        status = self.notify_forkchoice_updated(fc, attributes, fork)
        if status is not PayloadStatusV1.VALID or not self._last_payload_id:
            raise ExecutionLayerError(
                f"forkchoiceUpdated for payload build: {status}"
            )
        result = self._call(
            f"engine_getPayloadV{min(v, 4)}", [self._last_payload_id]
        )
        doc = result.get("executionPayload", result)
        return payload_from_json(doc, self.types, fork)

    def get_pow_block(self, block_hash):
        result = self._call(
            "eth_getBlockByHash", [_d(block_hash), False]
        )
        if result is None:
            return None
        from . import PowBlock

        return PowBlock(
            block_hash=_ud(result["hash"]),
            parent_hash=_ud(result["parentHash"]),
            total_difficulty=_uq(result.get("totalDifficulty", "0x0")),
        )


def _fork_of_payload(payload, types) -> ForkName:
    if hasattr(payload, "blob_gas_used"):
        if isinstance(payload, types.ExecutionPayloadElectra):
            return ForkName.ELECTRA
        return ForkName.DENEB
    if hasattr(payload, "withdrawals"):
        return ForkName.CAPELLA
    return ForkName.BELLATRIX


# -- test server (MockServer analog) ----------------------------------------


class MockEngineServer:
    """Serves an in-process ExecutionLayer over the engine JSON-RPC wire
    with JWT validation (execution_layer test_utils MockServer)."""

    def __init__(self, engine: ExecutionLayer, jwt_secret: bytes, types, E, port: int = 0):
        self.engine = engine
        self.jwt_secret = jwt_secret
        self.types = types
        self.E = E
        self._payload_ctx: dict[str, tuple] = {}
        self._next_payload_id = 1
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                try:
                    token = (self.headers.get("Authorization") or "").removeprefix(
                        "Bearer "
                    )
                    validate_jwt(token, server.jwt_secret)
                except JwtError as e:
                    self.send_response(401)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                    return
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                try:
                    result = server._dispatch(req["method"], req.get("params", []))
                    doc = {"jsonrpc": "2.0", "id": req["id"], "result": result}
                except Exception as e:  # noqa: BLE001
                    doc = {
                        "jsonrpc": "2.0",
                        "id": req.get("id"),
                        "error": {"code": -32000, "message": str(e)},
                    }
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.port = self._server.server_port
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "MockEngineServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="mock-engine"
        )
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    # -- dispatch ---------------------------------------------------------

    def _dispatch(self, method: str, params: list):
        if method.startswith("engine_newPayloadV"):
            v = int(method.removeprefix("engine_newPayloadV"))
            fork = {1: ForkName.BELLATRIX, 2: ForkName.CAPELLA,
                    3: ForkName.DENEB, 4: ForkName.ELECTRA}[v]
            payload = payload_from_json(params[0], self.types, fork)
            from types import SimpleNamespace

            # V3+ carry the blob versioned hashes and the parent beacon
            # block root (EIP-4788), which the block hash commits to: the
            # engine needs both to check it. (The JAX package's server
            # drops them, so every Deneb payload is INVALID over its wire.)
            request = SimpleNamespace(execution_payload=payload)
            if v >= 3:
                request.versioned_hashes = [_ud(h) for h in params[1]]
                request.parent_beacon_block_root = _ud(params[2])
            status = self.engine.notify_new_payload(request)
            return {"status": status.value, "latestValidHash": _d(payload.block_hash)}
        if method.startswith("engine_forkchoiceUpdatedV"):
            fc_doc, attr_doc = params[0], params[1]
            fc = ForkchoiceState(
                head_block_hash=_ud(fc_doc["headBlockHash"]),
                safe_block_hash=_ud(fc_doc["safeBlockHash"]),
                finalized_block_hash=_ud(fc_doc["finalizedBlockHash"]),
            )
            status = self.engine.notify_forkchoice_updated(fc, None)
            payload_id = None
            if attr_doc is not None:
                attributes = attributes_from_json(attr_doc, self.types)
                pid = f"0x{self._next_payload_id:016x}"
                self._next_payload_id += 1
                self._payload_ctx[pid] = (fc.head_block_hash, attributes)
                payload_id = pid
                status = PayloadStatusV1.VALID
            return {
                "payloadStatus": {"status": status.value, "latestValidHash": None},
                "payloadId": payload_id,
            }
        if method.startswith("engine_getPayloadV"):
            v = int(method.removeprefix("engine_getPayloadV"))
            fork = {1: ForkName.BELLATRIX, 2: ForkName.CAPELLA,
                    3: ForkName.DENEB, 4: ForkName.ELECTRA}[v]
            pid = params[0]
            ctx = self._payload_ctx.pop(pid, None)
            if ctx is None:
                raise ExecutionLayerError("unknown payloadId")
            parent_hash, attributes = ctx
            # verbatim, zeros included: a zero parent is the pre-merge /
            # capella-at-genesis default header, not "terminal block"
            payload = self.engine.get_payload(parent_hash, attributes, fork)
            return {"executionPayload": payload_to_json(payload)}
        if method == "eth_getBlockByNumber":
            gen = getattr(self.engine, "generator", None)
            if gen is None or not gen.blocks:
                return None
            blk = gen.latest()
            return {
                "hash": _d(blk.block_hash),
                "parentHash": _d(blk.parent_hash),
                "number": _q(blk.block_number),
            }
        if method == "eth_getBlockByHash":
            blk = self.engine.get_pow_block(_ud(params[0]))
            if blk is None:
                return None
            return {
                "hash": _d(blk.block_hash),
                "parentHash": _d(blk.parent_hash),
                "totalDifficulty": _q(blk.total_difficulty),
            }
        raise ExecutionLayerError(f"unknown method {method}")
