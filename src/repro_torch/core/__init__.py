"""Engine, store, substrates and workloads of the PyTorch port: the
single-device engine and the node mesh emulated on one device
(``dist_engine``)."""
from repro_torch.kernels import (KernelConfig, default_backend, resolve,
                                 set_default_backend)
from .commit_phase import (ABORTED, COMMITTED, NOP, READ, RMW, RUNNING,
                           WRITE)
from .engine import (SCHEDULERS, RunStats, StagedBlock, Wave, WaveOut,
                     run_block, run_wave, run_wave_on, run_workload,
                     run_workload_fused, stack_waves, stage_block,
                     staged_inputs, step_block, step_wave, wave_from_numpy,
                     wave_to_numpy)
from .store import (INF, NO_TID, MVStore, PlacementArrays,
                    as_placement_arrays, bump_sid,
                    evicting_visible, install_version, make_store,
                    node_of_key, read_newest, read_visible, store_from_numpy,
                    store_to_numpy)
from .substrate import (LocalSubstrate, MeshSubstrate,
                        effective_mesh_backend, mesh_degrade_count,
                        mesh_kernels)
from .dist_engine import (NodeMesh, make_node_mesh, mesh_watermark,
                          run_block_dist, run_wave_dist, run_workload_dist,
                          run_workload_fused_dist, shard_store,
                          step_block_dist, step_wave_dist)
from .verify import final_values_ok, verify_cv, verify_si
from . import workloads

__all__ = [
    "NOP", "READ", "RMW", "WRITE", "RUNNING", "COMMITTED", "ABORTED",
    "SCHEDULERS", "Wave", "WaveOut", "RunStats", "StagedBlock", "run_block",
    "run_wave", "run_wave_on", "run_workload", "run_workload_fused",
    "stack_waves", "stage_block", "staged_inputs", "step_block",
    "step_wave",
    "wave_from_numpy", "wave_to_numpy",
    "KernelConfig", "default_backend", "resolve", "set_default_backend",
    "INF", "NO_TID", "MVStore", "PlacementArrays", "as_placement_arrays",
    "bump_sid", "evicting_visible", "install_version",
    "make_store", "node_of_key", "read_newest", "read_visible",
    "store_from_numpy", "store_to_numpy", "LocalSubstrate",
    "MeshSubstrate", "effective_mesh_backend", "mesh_degrade_count",
    "mesh_kernels", "NodeMesh", "make_node_mesh", "mesh_watermark",
    "run_block_dist", "run_wave_dist", "run_workload_dist",
    "run_workload_fused_dist", "shard_store", "step_block_dist",
    "step_wave_dist",
    "final_values_ok", "verify_cv", "verify_si", "workloads",
]
