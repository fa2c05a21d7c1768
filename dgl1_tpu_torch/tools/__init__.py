"""Command-line tools of the port (``python -m dgl1_tpu_torch.tools.<name>``)."""
