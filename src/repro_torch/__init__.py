"""PilotDB on PyTorch and CUDA: the port of the ``repro`` package.

The port mirrors the reference's subpackages (``api``, ``core``, ``engine``,
``stats``, ``kernels``) so each module has a counterpart.  Its entry points
run on the CUDA card by default and raise when there is none; pass
``device="cpu"`` to run the kernels' plain PyTorch versions on the CPU.
Importing the package builds no kernel and touches no device.
"""
