"""Launchers (the reference's ``launch/``): ``serve`` stands up an LM
``Engine`` for an architecture, ``train`` trains one with the ``Trainer``."""
