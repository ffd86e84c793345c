"""Chain revert after consensus faults.

The beacon_chain/src/fork_revert.rs:25 analog (`revert_to_fork_boundary`):
when an imported segment turns out invalid (e.g. the execution layer
retro-actively reports a bad payload), wipe the offending block and every
descendant, rebuild fork choice from the finalized anchor over the
surviving blocks, and recompute the head. The reference persists a
"blacklisted blocks" set so the bad segment is not re-imported; we carry
the same set on the chain."""

from __future__ import annotations

from ..utils.logging import get_logger

log = get_logger("fork_revert")


def descendants_of(chain, root: bytes) -> set[bytes]:
    """All known blocks descending from `root` (inclusive)."""
    out = {root}
    # parent links point up; iterate to fixpoint over the block table
    changed = True
    while changed:
        changed = False
        for r, signed in list(chain._blocks_by_root.items()):
            if r not in out and bytes(signed.message.parent_root) in out:
                out.add(r)
                changed = True
    return out


def revert_to_fork_boundary(chain, bad_root: bytes) -> int:
    """Remove `bad_root` + descendants and rebuild fork choice from the
    finalized boundary. Returns the number of blocks wiped. Raises if the
    bad block is finalized — reverting finality means the weak-subjectivity
    assumption broke and the node must not continue (fork_revert.rs aborts
    with the same reasoning)."""
    from ..fork_choice import ForkChoice

    finalized = chain.finalized_checkpoint
    if bad_root == bytes(finalized.root) or bad_root == chain.genesis_block_root:
        raise RuntimeError(
            "cannot revert a finalized block: weak subjectivity violated"
        )

    doomed = descendants_of(chain, bad_root)
    anchor_root = bytes(finalized.root) or chain.genesis_block_root
    if anchor_root in doomed:
        raise RuntimeError(
            "cannot revert a finalized block: weak subjectivity violated"
        )

    # 1. drop doomed blocks/states everywhere
    for root in doomed:
        chain._blocks_by_root.pop(root, None)
        st = chain._states.pop(root, None)
        try:
            blk = chain.store.get_block(root)
            if blk is not None:
                chain.store.delete_block(root)
                chain.store.delete_state(blk.message.state_root)
            elif st is not None:
                chain.store.delete_state(st.hash_tree_root())
        except Exception:  # noqa: BLE001 — store may not hold it
            pass
    chain.invalid_block_roots.update(doomed)

    # 2. rebuild fork choice from the finalized anchor over survivors
    anchor_state = chain._states.get(anchor_root) or chain._load_state_for_block(
        anchor_root
    )
    if anchor_state is None:
        raise RuntimeError("finalized anchor state unavailable for revert")
    new_fc = ForkChoice.from_anchor(
        anchor_root, anchor_state, chain.spec, chain.E
    )
    new_fc.state_provider = chain._justified_state_provider

    survivors = sorted(
        (
            (signed.message.slot, root, signed)
            for root, signed in chain._blocks_by_root.items()
            if signed.message.slot > anchor_state.slot
        ),
    )
    current_slot = chain.slot_clock.now()
    for _slot, root, signed in survivors:
        if not new_fc.contains_block(bytes(signed.message.parent_root)):
            continue  # orphaned by the wipe
        state = chain._states.get(root) or chain._load_state_for_block(root)
        if state is None:
            continue
        new_fc.on_block(current_slot, signed.message, root, state)
    chain.fork_choice = new_fc

    # 3. head moves off the wiped segment
    if chain.head_root in doomed or not new_fc.contains_block(chain.head_root):
        chain.head_root = anchor_root
    chain.recompute_head()
    log.warning(
        "reverted chain segment",
        wiped=len(doomed),
        bad_block=bad_root.hex()[:12],
        new_head=chain.head_root.hex()[:12],
    )
    return len(doomed)
