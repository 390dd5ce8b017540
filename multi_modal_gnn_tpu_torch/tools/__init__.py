"""Command-line tools of the port (``python -m multi_modal_gnn_tpu_torch.tools.<name>``)."""
