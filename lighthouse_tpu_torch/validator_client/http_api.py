"""Validator-client keymanager API.

The validator_client/src/http_api analog (EIP-3030-era keymanager
standard): a small authenticated HTTP server on the VC exposing
GET/POST/DELETE /eth/v1/keystores plus the fee-recipient routes, so
operators manage keys without touching the VC's disk. Auth follows the
reference: a bearer token required on every request — generated at
startup and written to `token_path` (the reference's api-token.txt) when
one is configured, else exposed via `.token`."""

from __future__ import annotations

import json
import secrets

from ..crypto import bls
from ..crypto.keystore import Keystore
from ..utils.http_server import JsonHttpServer, JsonRequestHandler
from ..utils.logging import get_logger
from . import LocalKeystoreSigner

log = get_logger("vc.http")


class KeymanagerApi:
    """Route logic over a ValidatorClient (transport-independent)."""

    def __init__(self, vc):
        self.vc = vc

    def list_keystores(self) -> dict:
        return {
            "data": [
                {
                    "validating_pubkey": "0x" + bytes(pk).hex(),
                    "derivation_path": "",
                    "readonly": False,
                }
                for pk in self.vc.store.pubkeys()
            ]
        }

    def import_keystores(self, keystores: list[str], passwords: list[str]) -> dict:
        if len(keystores) != len(passwords):
            raise ValueError("keystores and passwords length mismatch")
        statuses = []
        # one set snapshot maintained incrementally: rebuilding it per
        # item is quadratic in the batch, which bites at 10k-key imports
        present = {bytes(pk) for pk in self.vc.store.pubkeys()}
        for ks_json, password in zip(keystores, passwords):
            try:
                ks = Keystore.from_json(ks_json)
                sk = bls.SecretKey(int.from_bytes(ks.decrypt(password), "big"))
                pk = bytes(sk.public_key().to_bytes())
                if pk in present:
                    statuses.append({"status": "duplicate"})
                    continue
                self.vc.store.add_validator(pk, LocalKeystoreSigner(sk))
                present.add(pk)
                statuses.append({"status": "imported"})
            except Exception as e:  # noqa: BLE001 — per-item contract
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    def delete_keystores(self, pubkeys: list[str]) -> dict:
        statuses = []
        for pk_hex in pubkeys:
            # per-item contract: one malformed pubkey must not abort the
            # batch (earlier deletions already happened) or lose the
            # interchange export
            try:
                pk = bytes.fromhex(pk_hex.removeprefix("0x"))
                if self.vc.store.remove_validator(pk):
                    statuses.append({"status": "deleted"})
                else:
                    statuses.append({"status": "not_found"})
            except Exception as e:  # noqa: BLE001
                statuses.append({"status": "error", "message": str(e)})
        gvr = (
            bytes(self.vc.chain.genesis_validators_root)
            if self.vc.chain is not None
            else b"\x00" * 32
        )
        interchange = self.vc.store.slashing_db.export_interchange(gvr)
        return {
            "data": statuses,
            "slashing_protection": json.dumps(interchange),
        }

    def get_fee_recipient(self, pubkey_hex: str) -> dict:
        prep = self.vc.preparation_service
        pk = bytes.fromhex(pubkey_hex.removeprefix("0x"))
        recipient = prep.per_validator.get(pk, prep.default_fee_recipient)
        return {
            "data": {
                "pubkey": pubkey_hex,
                "ethaddress": "0x" + recipient.hex(),
            }
        }

    def set_fee_recipient(self, pubkey_hex: str, ethaddress: str):
        recipient = bytes.fromhex(ethaddress.removeprefix("0x"))
        if len(recipient) != 20:
            raise ValueError("ethaddress must be 20 bytes")
        self.vc.preparation_service.set_fee_recipient(
            bytes.fromhex(pubkey_hex.removeprefix("0x")), recipient
        )


class KeymanagerServer(JsonHttpServer):
    def __init__(
        self,
        vc,
        port: int = 0,
        token: str | None = None,
        token_path: str | None = None,
    ):
        self.api = KeymanagerApi(vc)
        self.token = token or secrets.token_hex(32)
        if token_path:
            with open(token_path, "w") as f:
                f.write(self.token + "\n")
        api = self.api
        server = self

        class _Handler(JsonRequestHandler):
            def _authed(self) -> bool:
                auth = self.headers.get("Authorization", "")
                try:
                    return secrets.compare_digest(
                        auth, f"Bearer {server.token}"
                    )
                except TypeError:
                    return False  # non-ASCII header cannot be the token

            def do_GET(self):
                if not self._authed():
                    return self.send_json({"message": "unauthorized"}, 401)
                try:
                    if self.route == "/eth/v1/keystores":
                        return self.send_json(api.list_keystores())
                    if self.route.startswith("/eth/v1/validator/") and (
                        self.route.endswith("/feerecipient")
                    ):
                        pk = self.route.split("/")[-2]
                        return self.send_json(api.get_fee_recipient(pk))
                    return self.send_json({"message": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    return self.send_json({"message": str(e)}, 400)

            def do_POST(self):
                if not self._authed():
                    return self.send_json({"message": "unauthorized"}, 401)
                try:
                    body = self.read_json_body()
                    if self.route == "/eth/v1/keystores":
                        return self.send_json(
                            api.import_keystores(
                                body.get("keystores", []),
                                body.get("passwords", []),
                            )
                        )
                    if self.route.startswith("/eth/v1/validator/") and (
                        self.route.endswith("/feerecipient")
                    ):
                        pk = self.route.split("/")[-2]
                        api.set_fee_recipient(pk, body["ethaddress"])
                        return self.send_json({}, 202)
                    return self.send_json({"message": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    return self.send_json({"message": str(e)}, 400)

            def do_DELETE(self):
                if not self._authed():
                    return self.send_json({"message": "unauthorized"}, 401)
                try:
                    body = self.read_json_body()
                    if self.route == "/eth/v1/keystores":
                        return self.send_json(
                            api.delete_keystores(body.get("pubkeys", []))
                        )
                    return self.send_json({"message": "not found"}, 404)
                except Exception as e:  # noqa: BLE001
                    return self.send_json({"message": str(e)}, 400)

        super().__init__(_Handler, port=port, name="vc-keymanager")

    def start(self) -> "KeymanagerServer":
        super().start()
        log.info("keymanager API up", port=self.port)
        return self
