"""Runnable examples of the port (``python -m vit_tpu_torch.examples.<name>``)."""
