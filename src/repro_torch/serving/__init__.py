"""Serving engines (the reference's ``serving/``): the LM ``Engine`` so far;
``FleetEngine`` waits for ROADMAP Queue 1 item 9."""
