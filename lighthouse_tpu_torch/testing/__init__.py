"""Test fixtures (counterpart of lighthouse_tpu/testing): the state
harness and the conformance runner."""
