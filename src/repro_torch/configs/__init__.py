"""Model configurations the port runs (the paper's BNNs)."""
