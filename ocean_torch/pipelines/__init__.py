from . import ud_construction, limits, ocp

__all__ = ["ud_construction", "limits", "ocp"]
