"""Training of the port: the reference's ``train/`` (AdamW, the train step,
error-feedback compression, the data pipeline with its AQP-planned
mixture, checkpoints in the reference's layout, the elastic planner,
``make_mesh`` and the straggler watchdog, and ``sharding``: the FSDP x TP
rules as DTensor placements) on the card, through the flash and GLA kernels
forward and backward, on one card or a device mesh."""
