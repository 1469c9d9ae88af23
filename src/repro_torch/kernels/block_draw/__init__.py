from repro_torch.kernels.block_draw.ops import block_draw
from repro_torch.kernels.block_draw.ref import block_draw_ref, pcg64_state

__all__ = ["block_draw", "block_draw_ref", "pcg64_state"]
