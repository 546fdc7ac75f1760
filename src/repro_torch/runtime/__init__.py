"""Runtime plane of the PyTorch port: deterministic fault injection at the
service seams (``faults``), and the training runtime: the fault-tolerant
``TrainRunner`` with its ``FailureInjector`` and the ``StragglerPolicy``.
"""
from .faults import Fault, FaultSchedule, InjectedCrash
from .runner import FailureInjector, TrainRunner
from .straggler import StragglerPolicy

__all__ = ["FailureInjector", "Fault", "FaultSchedule", "InjectedCrash",
           "StragglerPolicy", "TrainRunner"]
