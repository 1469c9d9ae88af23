"""Progressive answer streaming (copied from the reference, imports
rewired): every query can be observed as a monotone stream of typed frames —
an advisory PilotFrame the moment TAQA's stage 1 returns, then exactly one
terminal frame (FinalFrame with the §4 guarantee, ExactFrame on fallback,
ErrorFrame on captured failure).  The FrameBuffer is the thread-safe
plumbing behind ``QueryHandle.stream()`` / ``on_frame()``.  Frames hold
host numpy arrays and the delivered answer object, never a tensor: the
values the port delivers are already host f64."""

from repro_torch.stream.buffer import FrameBuffer
from repro_torch.stream.frames import (ErrorFrame, ExactFrame, FinalFrame, Frame,
                                       PilotFrame, final_frame_for, pilot_frame_for)

__all__ = [
    "Frame",
    "PilotFrame",
    "FinalFrame",
    "ExactFrame",
    "ErrorFrame",
    "FrameBuffer",
    "final_frame_for",
    "pilot_frame_for",
]
