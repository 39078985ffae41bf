from .point_sources import point_source_rhs

__all__ = ["point_source_rhs"]
