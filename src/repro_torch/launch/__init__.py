"""Command-line entry points of the port (``python -m repro_torch.launch.<name>``).

``serve`` (batched requests through the slot engine), ``train`` (the
training driver), ``specs`` (the assigned input shapes of every arch, as
``(shape, dtype)`` specs), ``dryrun`` (every arch x shape cell traced on a
fake 256- or 512-rank production mesh, per-device memory, FLOPs and
collective bytes), ``roofline`` (the dry run's cells against one H100's
peaks).  ``mesh`` builds the production, host and fake-world meshes;
``trace_analysis`` counts a traced step's per-device work, the counterpart
of the reference's ``hlo_analysis``.
"""
