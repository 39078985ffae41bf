from . import ud_construction, limits

__all__ = ["ud_construction", "limits"]
