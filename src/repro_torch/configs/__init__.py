"""Model configurations the port runs: the paper's BNNs (``n2net_paper``) and
the LM architectures (``base`` schema and registry, one module per model)."""
