"""Beacon chain orchestration (beacon_node/beacon_chain equivalent).

Slice 1 holds only the tree-states conversion block import relies on
(`chain._make_persistent`)."""
