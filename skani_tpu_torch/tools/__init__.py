"""Measuring tools of the port: run each as `python -m skani_tpu_torch.tools.<name>`."""
