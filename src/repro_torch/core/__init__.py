"""repro_torch.core — the paper's contribution on torch tensors: the
digital-PIM machine model, AritPIM bit-serial arithmetic, bit-plane packing,
the Schedule-IR compiler with its executor backends, bit-exact simulation,
the analytical cost model, the CC/reuse metrics and the Fig-8 offload
analyzer."""

from . import analyzer, aritpim, bitplanes, costmodel, ir, machine, metrics, simulate
from .analyzer import OffloadVerdict, Workload, analyze
from .costmodel import (
    A100,
    A6000,
    DRAM_PIM,
    H100,
    MEMRISTIVE_PIM,
    PAPER_GATE_COUNTS,
    PAPER_PIM_THROUGHPUT,
    GPUConfig,
    PIMConfig,
)
from .ir import CompiledSchedule, ScheduleIR, compile_op, get_backend, register_backend
from .machine import PlaneVM, Schedule, execute_schedule

__all__ = [
    "analyzer", "aritpim", "bitplanes", "costmodel", "ir", "machine", "metrics",
    "simulate", "OffloadVerdict", "Workload", "analyze",
    "A100", "A6000", "DRAM_PIM", "H100", "MEMRISTIVE_PIM", "PAPER_GATE_COUNTS",
    "PAPER_PIM_THROUGHPUT", "GPUConfig", "PIMConfig",
    "CompiledSchedule", "ScheduleIR", "compile_op", "get_backend", "register_backend",
    "PlaneVM", "Schedule", "execute_schedule",
]
