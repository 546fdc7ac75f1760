"""The port's shape cells, registry, parameter counts and input specs held
against the JAX package's, for all ten full configs.

* ``configs.SHAPES``, ``LONG_OK_FAMILIES`` and ``applicable``: the same
  four cells and the same 32 live (architecture, cell) pairs of 40;
* ``all_configs``: the same ids, families and parameter counts;
* ``models.module.count_params`` of each full config's spec tree equals
  the reference's ``count_params``;
* ``launch.inputs.input_specs`` of every architecture x applicable cell:
  the same keys, shapes and dtypes as the reference's
  ``ShapeDtypeStruct`` trees (``cache["len"]``: the filled length, where
  the reference has an int32 scalar);
* ``launch.dryrun.model_flops`` equals the reference's for every live
  cell (the reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it
  is imported, so it runs in a child python);
* ``launch.mesh.make_cc_node_mesh`` is the node mesh.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.configs import applicable as j_applicable
from repro.configs.shapes import LONG_OK_FAMILIES as J_LONG_OK
from repro.launch.inputs import input_specs as j_input_specs
from repro.models.model import build as j_build
from repro.models.module import count_params as j_count_params
from repro_torch.configs import ARCH_IDS, SHAPES, all_configs, applicable
from repro_torch.configs.shapes import LONG_OK_FAMILIES
from repro_torch.core import NodeMesh
from repro_torch.launch.dryrun import model_flops
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_cc_node_mesh
from repro_torch.models.model import build
from repro_torch.models.module import count_params

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def live_cells():
    cfgs = all_configs()
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if applicable(cfgs[a].family, s)]


def test_shape_cells_equal_the_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, cell in SHAPES.items():
        ref = J_SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert LONG_OK_FAMILIES == J_LONG_OK
    for fam in FAMILIES:
        for s in SHAPES:
            assert applicable(fam, s) == j_applicable(fam, s)
    assert len(live_cells()) == 32


def test_all_configs_equal_the_reference():
    got, want = all_configs(), j_all_configs()
    assert list(got) == list(want) == ARCH_IDS
    for a in ARCH_IDS:
        assert got[a].name == want[a].name
        assert got[a].family == want[a].family
        assert got[a].param_count() == want[a].param_count()
        assert got[a].param_count(active_only=True) == \
            want[a].param_count(active_only=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_the_reference(arch):
    cfg, jcfg = all_configs()[arch], j_all_configs()[arch]
    assert count_params(build(cfg).param_specs()) == \
        j_count_params(j_build(jcfg).param_specs())


def _specs(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of tensors / ShapeDtypeStructs
    (ints as themselves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_specs(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, int):
        return {prefix: tree}
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = all_configs()[arch], j_all_configs()[arch]
    for name, cell in SHAPES.items():
        if not applicable(cfg.family, name):
            continue
        for mode in ("train", "prefill", "decode"):
            got = input_specs(cfg, cell, mode)
            want = j_input_specs(jcfg, J_SHAPES[name], mode)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert all(t.device.type == "meta"
                           for t in g.values() if isinstance(t, torch.Tensor))
                gs, ws = _specs(g), _specs(w)
                if "/len" in ws:       # the filled length of a decode cache
                    assert ws.pop("/len") == ((), "int32")
                    assert gs.pop("/len") == cell.seq_len
                assert gs == ws, (arch, name, mode)
        assert input_specs(cfg, cell)[0].keys() == \
            j_input_specs(jcfg, J_SHAPES[name])[0].keys()


def test_model_flops_equal_the_reference():
    code = (
        "import json\n"
        "from repro.configs import ARCH_IDS, SHAPES, applicable, get_config\n"
        "from repro.launch.dryrun import model_flops\n"
        "print(json.dumps({f'{a}/{s}': model_flops(get_config(a), SHAPES[s])"
        " for a in ARCH_IDS for s in SHAPES"
        " if applicable(get_config(a).family, s)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    want = json.loads(out.strip().splitlines()[-1])
    cfgs = all_configs()
    got = {f"{a}/{s}": model_flops(cfgs[a], SHAPES[s])
           for a, s in live_cells()}
    assert got == want and len(got) == 32


def test_make_cc_node_mesh():
    mesh = make_cc_node_mesh(4, "cpu")
    assert isinstance(mesh, NodeMesh) and mesh.n_nodes == 4
    assert mesh.device == torch.device("cpu")
    assert make_cc_node_mesh(device="meta").n_nodes == 8
