"""setup_s: seconds from the start of the process to the first timed query
(CUDA start-up, the tables made on the card, the session, the kernel
libraries loaded or built, and the warm-up of the cell's own queries)."""


def read(ctx):
    return ctx.setup_s
