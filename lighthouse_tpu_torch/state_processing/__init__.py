"""State transition (counterpart of lighthouse_tpu/state_processing).

Ported so far: the signature-set constructors of a block
(`signature_sets`, `altair.sync_aggregate_signature_set`) and the
accessors they read. The rest waits for the state-processing slice.
"""
