"""Dataplane simulator: lowering to op-tables, traffic, batched executor."""
