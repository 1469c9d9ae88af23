"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``).

Only ``serve`` so far: the reference's ``launch/`` is TPU-mesh and XLA-HLO
tooling, and its H100 counterparts are still to come.
"""
