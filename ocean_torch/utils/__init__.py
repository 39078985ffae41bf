from .timing import sync, Timer

__all__ = ["sync", "Timer"]
