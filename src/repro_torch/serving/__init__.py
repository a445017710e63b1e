"""Serving engines (the reference's ``serving/``): the LM ``Engine`` and the
dataplane ``FleetEngine`` with its ``FleetHealth`` snapshot."""
