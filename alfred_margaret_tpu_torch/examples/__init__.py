"""Runnable walkthroughs of the port (``python -m alfred_margaret_tpu_torch.examples.<name>``)."""
