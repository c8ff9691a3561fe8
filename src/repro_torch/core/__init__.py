"""repro_torch.core — the paper's contribution on torch tensors: the
digital-PIM machine model, AritPIM bit-serial arithmetic, bit-plane packing
and the Schedule-IR compiler with its executor backends."""

from . import aritpim, bitplanes, ir, machine
from .ir import CompiledSchedule, ScheduleIR, compile_op, get_backend, register_backend
from .machine import PlaneVM, Schedule, execute_schedule

__all__ = [
    "aritpim", "bitplanes", "ir", "machine",
    "CompiledSchedule", "ScheduleIR", "compile_op", "get_backend", "register_backend",
    "PlaneVM", "Schedule", "execute_schedule",
]
