"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` (batched requests through the slot engine), ``train`` (the
training driver) and ``specs`` (the assigned input shapes of every arch, as
``(shape, dtype)`` specs).  The rest of the reference's ``launch/`` is
TPU-mesh and XLA-HLO tooling, whose H100 counterparts are still to come.
"""
