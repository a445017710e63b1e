"""Training: the BNN trainer and atomic checkpoints (the reference's ``train/``)."""
