"""Command-line tools of the port
(``python -m placement_tpu_torch.tools.<name>``)."""
