"""Runtime fault plane of the PyTorch port: deterministic fault injection
at the service seams.  The reference's training runner and straggler
detector come with the model plane's training (ROADMAP.md queue 1, item
"Model plane")."""
from .faults import Fault, FaultSchedule, InjectedCrash

__all__ = ["Fault", "FaultSchedule", "InjectedCrash"]
