from . import (ud_construction, limits, ocp, stokes_gradcheck, ns_gradcheck,
               initial_control)

__all__ = ["ud_construction", "limits", "ocp", "stokes_gradcheck",
           "ns_gradcheck", "initial_control"]
