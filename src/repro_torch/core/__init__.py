"""Engine, store, substrate and workloads of the PyTorch port (single
device)."""
from repro_torch.kernels import (KernelConfig, default_backend, resolve,
                                 set_default_backend)
from .commit_phase import (ABORTED, COMMITTED, NOP, READ, RMW, RUNNING,
                           WRITE)
from .engine import (SCHEDULERS, RunStats, Wave, WaveOut, run_block,
                     run_wave, run_wave_on, run_workload, run_workload_fused,
                     stack_waves, step_block, step_wave, wave_from_numpy,
                     wave_to_numpy)
from .store import (INF, NO_TID, MVStore, PlacementArrays,
                    as_placement_arrays, bump_sid,
                    evicting_visible, install_version, make_store,
                    node_of_key, read_newest, read_visible, store_from_numpy,
                    store_to_numpy)
from .substrate import LocalSubstrate
from .verify import final_values_ok, verify_cv, verify_si
from . import workloads

__all__ = [
    "NOP", "READ", "RMW", "WRITE", "RUNNING", "COMMITTED", "ABORTED",
    "SCHEDULERS", "Wave", "WaveOut", "RunStats", "run_block", "run_wave",
    "run_wave_on", "run_workload", "run_workload_fused", "stack_waves",
    "step_block", "step_wave", "wave_from_numpy", "wave_to_numpy",
    "KernelConfig", "default_backend", "resolve", "set_default_backend",
    "INF", "NO_TID", "MVStore", "PlacementArrays", "as_placement_arrays",
    "bump_sid", "evicting_visible", "install_version",
    "make_store", "node_of_key", "read_newest", "read_visible",
    "store_from_numpy", "store_to_numpy", "LocalSubstrate",
    "final_values_ok", "verify_cv", "verify_si", "workloads",
]
