"""Per-rank counts of a traced step and the roofline they give on an H100."""

from .counters import (StepCounter, collective_bytes_by_axis_kind,
                       collective_bytes_by_kind)
from .analysis import H100, HardwareSpec, RooflineReport, roofline_terms

__all__ = ["StepCounter", "collective_bytes_by_kind", "collective_bytes_by_axis_kind",
           "H100", "HardwareSpec", "RooflineReport", "roofline_terms"]
