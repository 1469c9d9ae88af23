from repro_torch.kernels.taqa_solve.ops import taqa_draw_compact, taqa_solve_rate
from repro_torch.kernels.taqa_solve.ref import taqa_draw_compact_ref, taqa_solve_rate_ref

__all__ = ["taqa_solve_rate", "taqa_draw_compact", "taqa_solve_rate_ref",
           "taqa_draw_compact_ref"]
