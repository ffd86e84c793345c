"""Genesis state construction + deposit Merkle tree.

Counterpart of lighthouse_tpu/state_processing/genesis.py, copied.

Mirrors beacon_node/genesis (eth1 genesis + `interop_genesis_state`,
genesis/src/interop.rs:31) and consensus/merkle_proof (deposit tree proofs).
"""

from __future__ import annotations

from ..crypto import bls
from ..types.chain_spec import GENESIS_EPOCH, ChainSpec, compute_signing_root
from ..utils.hash import ZERO_HASHES, hash32_concat
from .per_block import DEPOSIT_CONTRACT_TREE_DEPTH, apply_deposit, process_deposit

BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_WITHDRAWAL_PREFIX = b"\x01"


class DepositTree:
    """Incremental sparse Merkle tree of deposit data roots (depth 32, count
    mixed in) — the deposit contract's tree (consensus/merkle_proof
    equivalent). Complete subtrees are memoized, so append + root + proof
    are O(depth) amortized (genesis builds n proofs in O(n·depth))."""

    DEPTH = DEPOSIT_CONTRACT_TREE_DEPTH

    def __init__(self):
        self.leaves: list[bytes] = []
        self._memo: dict[tuple[int, int], bytes] = {}

    def push(self, deposit_data_root: bytes):
        self.leaves.append(deposit_data_root)

    def _subtree_root(self, start: int, depth: int) -> bytes:
        """Root of the subtree of height `depth` covering leaves
        [start, start + 2^depth)."""
        if depth == 0:
            return self.leaves[start] if start < len(self.leaves) else ZERO_HASHES[0]
        if start >= len(self.leaves):
            return ZERO_HASHES[depth]
        complete = start + (1 << depth) <= len(self.leaves)
        if complete:
            cached = self._memo.get((start, depth))
            if cached is not None:
                return cached
        mid = start + (1 << (depth - 1))
        val = hash32_concat(
            self._subtree_root(start, depth - 1),
            self._subtree_root(mid, depth - 1),
        )
        if complete:
            self._memo[(start, depth)] = val
        return val

    def root(self) -> bytes:
        """deposit_root: tree root mixed with leaf count (little-endian)."""
        tree = self._subtree_root(0, self.DEPTH)
        return hash32_concat(tree, len(self.leaves).to_bytes(32, "little"))

    def proof(self, index: int) -> list[bytes]:
        """Merkle branch for leaf `index`: 32 siblings + the count chunk
        (total DEPTH+1, matching Deposit.proof)."""
        assert index < len(self.leaves)
        branch = []
        start, depth = 0, self.DEPTH
        for level in range(self.DEPTH):
            bit = (index >> (self.DEPTH - 1 - level)) & 1
            mid = start + (1 << (depth - 1))
            if bit:
                branch.append(self._subtree_root(start, depth - 1))
                start = mid
            else:
                branch.append(self._subtree_root(mid, depth - 1))
            depth -= 1
        branch.reverse()  # proof is leaf-to-root order
        branch.append(len(self.leaves).to_bytes(32, "little"))
        return branch


# ---------------------------------------------------------------------------
# Genesis
# ---------------------------------------------------------------------------


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits,
    spec: ChainSpec,
    E,
):
    """Spec initialize_beacon_state_from_eth1 (phase0)."""
    from ..types.containers import build_types

    t = build_types(E)
    state = t.BeaconState(
        genesis_time=eth1_timestamp + spec.genesis_delay,
        fork=t.Fork(
            previous_version=spec.genesis_fork_version,
            current_version=spec.genesis_fork_version,
            epoch=GENESIS_EPOCH,
        ),
        eth1_data=t.Eth1Data(
            deposit_count=len(deposits), block_hash=eth1_block_hash
        ),
        latest_block_header=t.BeaconBlockHeader(
            body_root=t.BeaconBlockBody().hash_tree_root()
        ),
        randao_mixes=[eth1_block_hash] * E.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    # Pre-verify all new-validator deposit signatures in one batch (falls
    # back to per-deposit verification inside process_deposit on failure) —
    # the same bulk-then-individual pattern the reference uses for blocks.
    all_sigs_ok = False
    if not bls.get_backend().fake and deposits:
        from .signature_sets import deposit_signature_message

        try:
            sets = [
                bls.SignatureSet.single(
                    bls.Signature(d.data.signature),
                    bls.PublicKey.from_bytes(d.data.pubkey),
                    deposit_signature_message(d.data, spec, E),
                )
                for d in deposits
            ]
            all_sigs_ok = bls.verify_signature_sets(sets)
        except (bls.BlsError, ValueError):
            all_sigs_ok = False

    # Process deposits with an incrementally-updated deposit root.
    leaves_so_far = DepositTree()
    for index, deposit in enumerate(deposits):
        leaves_so_far.push(deposit.data.hash_tree_root())
        state.eth1_data.deposit_root = leaves_so_far.root()
        process_deposit(state, deposit, spec, E, signature_verified=all_sigs_ok)

    # Process activations
    from .accessors import mutable_validator

    from ..utils.safe_arith import safe_sub

    for index in range(len(state.validators)):
        balance = state.balances[index]
        validator = mutable_validator(state, index)
        validator.effective_balance = min(
            # b - b % inc is exact by construction; safe_sub documents it
            safe_sub(balance, balance % E.EFFECTIVE_BALANCE_INCREMENT),
            E.MAX_EFFECTIVE_BALANCE,
        )
        if validator.effective_balance == E.MAX_EFFECTIVE_BALANCE:
            validator.activation_eligibility_epoch = GENESIS_EPOCH
            validator.activation_epoch = GENESIS_EPOCH

    # Set genesis validators root for domain separation
    state.genesis_validators_root = type(state)._fields[
        "validators"
    ].hash_tree_root_of(state.validators)
    return state


def is_valid_genesis_state(state, spec: ChainSpec, E) -> bool:
    if state.genesis_time < spec.min_genesis_time:
        return False
    from .accessors import get_active_validator_indices

    return (
        len(get_active_validator_indices(state, GENESIS_EPOCH))
        >= spec.min_genesis_active_validator_count
    )


# ---------------------------------------------------------------------------
# Interop genesis (deterministic keys)
# ---------------------------------------------------------------------------


def bls_withdrawal_credentials(pubkey: bytes) -> bytes:
    from ..utils.hash import sha256

    return BLS_WITHDRAWAL_PREFIX + sha256(pubkey)[1:]


def build_deposit_data(keypair, amount: int, spec: ChainSpec, E):
    """Signed DepositData for a keypair (deposit domain, pre-genesis)."""
    from ..types.containers import build_types

    t = build_types(E)
    msg = t.DepositMessage(
        pubkey=keypair.pk.to_bytes(),
        withdrawal_credentials=bls_withdrawal_credentials(keypair.pk.to_bytes()),
        amount=amount,
    )
    signing_root = compute_signing_root(
        msg.hash_tree_root(), spec.get_deposit_domain()
    )
    sig = keypair.sk.sign(signing_root)
    return t.DepositData(
        pubkey=msg.pubkey,
        withdrawal_credentials=msg.withdrawal_credentials,
        amount=amount,
        signature=sig.to_bytes(),
    )


def interop_genesis_state(
    keypairs,
    genesis_time: int,
    eth1_block_hash: bytes,
    spec: ChainSpec,
    E,
):
    """Deterministic-key genesis (genesis/src/interop.rs:31 equivalent):
    one MAX_EFFECTIVE_BALANCE deposit per keypair, then genesis_time forced
    to the caller's value."""
    datas = [
        build_deposit_data(kp, E.MAX_EFFECTIVE_BALANCE, spec, E) for kp in keypairs
    ]
    # The spec genesis loop verifies each deposit against the root-so-far,
    # so each deposit carries a proof against the tree at its own index.
    state = _genesis_with_incremental_proofs(
        eth1_block_hash, genesis_time, datas, spec, E
    )
    state.genesis_time = genesis_time
    # Specs that schedule forks at epoch 0 start the chain in that fork
    # (the reference's fork_from_env genesis, test_utils.rs).
    from ..types.chain_spec import ForkName
    from ..types.containers import build_types

    target_fork = spec.fork_name_at_epoch(GENESIS_EPOCH)
    if target_fork != ForkName.PHASE0:
        from .upgrades import apply_upgrades

        apply_upgrades(
            state, build_types(E).fork_of_state(state), target_fork, spec, E
        )
        # Fork-at-genesis networks set previous_version == current_version
        # (reference consensus/state_processing/src/genesis.rs:58); leaving
        # the phase0 genesis version would diverge fork digests.
        state.fork.previous_version = state.fork.current_version
    return state


def _genesis_with_incremental_proofs(eth1_block_hash, genesis_time, datas, spec, E):
    from ..types.containers import build_types

    t = build_types(E)
    incremental = DepositTree()
    deposits = []
    for i, d in enumerate(datas):
        incremental.push(d.hash_tree_root())
        deposits.append(t.Deposit(proof=incremental.proof(i), data=d))
    # Each deposit's proof is valid against the tree state at its own index
    # (count = i+1), exactly how the spec genesis verifies them.
    return initialize_beacon_state_from_eth1(
        eth1_block_hash, 0, deposits, spec, E
    )
