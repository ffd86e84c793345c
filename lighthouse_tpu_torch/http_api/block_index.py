"""Block-root-indexed header/block lookups for the API serving tier.

The seed's `/headers/{slot}` path scanned every hot block and re-hashed
the body per request, and any root that had fallen to the store was
re-deserialized on every hit. This index keeps:

  * a slot → roots map and a parent-root → child-roots map over the hot
    block set (synced by key-set diff — one set compare per request in
    steady state, surgical removal when finalization prunes fork roots),
  * one precomputed header entry per root (body root hashed ONCE per
    block, signature hex'd once) serving both the single `/headers/{id}`
    route and the `/headers` list route,
  * a bounded LRU of store-loaded blocks; a store root's header entry
    lives and dies with its LRU slot, so serving a pruned block costs
    one deserialization per residency, not per request.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

_STORE_LRU_CAP = 256


class BlockHeaderIndex:
    def __init__(self, chain):
        self._chain = chain
        self._hot: set[bytes] = set()
        self._by_slot: dict[int, list[bytes]] = {}
        self._by_parent: dict[bytes, list[bytes]] = {}
        self._headers: dict[bytes, dict] = {}
        self._store_lru: OrderedDict[bytes, object] = OrderedDict()
        self._lock = threading.Lock()

    # -- incremental sync over the hot block set -------------------------

    def sync(self):
        """Key-set diff against the chain's hot block map: additions are
        indexed, pruned roots are removed surgically — a prune balanced
        by an equal number of imports (same dict length) is still
        caught."""
        blocks = self._chain._blocks_by_root
        store = getattr(self._chain, "store", None)
        with self._lock:
            # prune-while-serving: a migration batch pops hot roots while
            # we snapshot the key set. Retry on a torn iteration OR when
            # the store generation moved mid-snapshot — the settled view
            # is one bounded retry away (batches are finite and the
            # import lock serializes them).
            keys = None
            for _attempt in range(3):
                gen = store.generation if store is not None else None
                try:
                    keys = set(blocks)
                except RuntimeError:  # dict mutated during iteration
                    keys = None
                    continue
                if store is None or store.generation == gen:
                    break
            if keys is None:
                return  # batch still churning; next request resyncs
            if keys == self._hot:
                return
            for root in self._hot - keys:
                self._remove(root)
            for root in keys - self._hot:
                signed = blocks.get(root)
                # a store-loaded root re-entering the hot set already has
                # its entry; contents are identical either way
                if signed is not None and root not in self._headers:
                    self._add(root, signed)
            self._hot = keys

    def _add(self, root: bytes, signed):
        m = signed.message
        self._headers[root] = {
            "message": {
                "slot": str(int(m.slot)),
                "proposer_index": str(int(m.proposer_index)),
                "parent_root": "0x" + bytes(m.parent_root).hex(),
                "state_root": "0x" + bytes(m.state_root).hex(),
                # hashed once per block, not once per request
                "body_root": "0x" + m.body.hash_tree_root().hex(),
            },
            "signature": "0x" + bytes(signed.signature).hex(),
        }
        self._by_slot.setdefault(int(m.slot), []).append(root)
        self._by_parent.setdefault(bytes(m.parent_root), []).append(root)

    def _remove(self, root: bytes):
        entry = self._headers.pop(root, None)
        if entry is None:
            return
        slot = int(entry["message"]["slot"])
        parent = bytes.fromhex(entry["message"]["parent_root"][2:])
        for table, key in ((self._by_slot, slot), (self._by_parent, parent)):
            roots = table.get(key)
            if roots is not None:
                if root in roots:
                    roots.remove(root)
                if not roots:
                    del table[key]

    # -- lookups ---------------------------------------------------------

    def roots_at_slot(self, slot: int) -> list[bytes]:
        self.sync()
        with self._lock:
            return list(self._by_slot.get(int(slot), ()))

    def roots_by_parent(self, parent_root: bytes) -> list[bytes]:
        self.sync()
        with self._lock:
            return list(self._by_parent.get(bytes(parent_root), ()))

    def header_entry(self, root: bytes) -> dict | None:
        """Precomputed header JSON fragment (message + signature) for a
        hot or store-resident block root."""
        self.sync()
        with self._lock:
            entry = self._headers.get(root)
        if entry is not None:
            return entry
        signed = self.block(root)
        if signed is None:
            return None
        with self._lock:
            if root not in self._headers:
                self._add(root, signed)
            return self._headers.get(root)

    def block(self, root: bytes):
        """The signed block for a root: hot set, then the store-load LRU,
        then ONE store deserialization (cached)."""
        root = bytes(root)
        b = self._chain._blocks_by_root.get(root)
        if b is not None:
            return b
        with self._lock:
            b = self._store_lru.get(root)
            if b is not None:
                self._store_lru.move_to_end(root)
                return b
        store = getattr(self._chain, "store", None)
        if store is None:
            return None
        gen = store.generation
        b = store.get_block(root)
        if b is None and store.generation != gen:
            # a migration batch ran underneath the lookup (hot map miss →
            # store miss can tear across the hot-delete/cold-put handoff);
            # one retry reads the settled view
            b = store.get_block(root)
        if b is None:
            return None
        with self._lock:
            self._store_lru[root] = b
            while len(self._store_lru) > _STORE_LRU_CAP:
                old_root, _ = self._store_lru.popitem(last=False)
                # the store root's header entry follows its block out of
                # the LRU (unless the root has meanwhile become hot)
                if old_root not in self._hot:
                    self._remove(old_root)
        return b
