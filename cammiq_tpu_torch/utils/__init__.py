from .timing import stage_timer, Timings

__all__ = ["stage_timer", "Timings"]
