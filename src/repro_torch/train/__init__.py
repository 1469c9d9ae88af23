"""Training of the port: the reference's ``train/`` (AdamW, the train step,
error-feedback compression, the data pipeline with its AQP-planned
mixture, checkpoints in the reference's layout, the elastic planner and
straggler watchdog) on the card, through the flash and GLA kernels forward
and backward.  ``train/sharding.py`` and ``elastic.make_mesh`` wait for the
port's device mesh (ROADMAP)."""
