"""Command-line entry points of the port (`python -m t2onet_tpu_torch.cli.<name>`)."""
