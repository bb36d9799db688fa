"""Launchers of the port: serving (``python -m repro_torch.launch.serve``)."""
