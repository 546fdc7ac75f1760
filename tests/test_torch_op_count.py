"""The counter's FLOPs (``launch.op_count``) held against the reference's
HLO analysis (``repro.launch.hlo_analysis.analyze`` of the JAX step
compiled on the CPU), on the reduced configs of the four model kinds at
B=2, S=64, the port on the ``torch`` route and the ``meta`` device.

* prefill: equal exactly for the dense (qwen2-0.5b), SSM (mamba2-130m),
  MoE (deepseek-moe-16b) and hybrid (zamba2-2.7b) families;
* the train step (loss, gradient, AdamW): equal exactly for dense and
  MoE; within 2% for SSM and hybrid.  The gap is the SSD scan's backward:
  the port's ``torch`` route differentiates its ``ssd_chunked`` with
  PyTorch's autograd, the reference with XLA's autodiff of its own
  ``ssd_chunked``, and the two form the gradient's products differently
  (measured 0.9978 and 0.9841 of the reference's count);
* the count splits FLOPs by the operands' dtype: every product of the
  bf16 compute is counted under bfloat16, the float32 ones (the
  unembed's, the router's) under float32.
"""
import jax
import pytest

from repro.configs import get_reduced as j_get_reduced
from repro.configs.shapes import ShapeCell as JShapeCell
from repro.launch.hlo_analysis import analyze
from repro.launch.inputs import input_specs as j_input_specs
from repro.launch.train import abstract_train_state as j_abstract_train_state
from repro.launch.train import make_prefill_step as j_make_prefill_step
from repro.launch.train import make_train_step as j_make_train_step
from repro.models.module import abstract as j_abstract
from repro_torch.configs import ShapeCell, get_reduced
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.op_count import count_call
from repro_torch.launch.train import (abstract_train_state, make_prefill_step,
                                      make_train_step)
from repro_torch.models.module import abstract

B, S = 2, 64
# family -> (reduced architecture, train-step FLOPs over the reference's:
# None where they must be equal)
KINDS = {"dense": ("qwen2-0.5b", None), "ssm": ("mamba2-130m", 0.02),
         "moe": ("deepseek-moe-16b", None), "hybrid": ("zamba2-2.7b", 0.02)}


def _ref_flops(step, *args):
    return analyze(jax.jit(step).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_flops_equal_the_reference(kind):
    arch, _ = KINDS[kind]
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    jm, jstep = j_make_prefill_step(jc)
    want = _ref_flops(jstep, j_abstract(jm.param_specs()),
                      j_input_specs(jc, JShapeCell("p", S, B, "prefill"))[0])
    model, step = make_prefill_step(tc, kernels="torch")
    _, got = count_call(step, abstract(model.param_specs()),
                        input_specs(tc, ShapeCell("p", S, B, "prefill"))[0])
    assert got["flops"] == want
    assert got["kernels"] == {}
    assert set(got["flops_by_dtype"]) <= {"bfloat16", "float32"}


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_flops_against_the_reference(kind):
    arch, tol = KINDS[kind]
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    _, jp, jo = j_abstract_train_state(jc)
    _, jstep = j_make_train_step(jc)
    want = _ref_flops(jstep, jp, jo,
                      j_input_specs(jc, JShapeCell("t", S, B, "train"))[0])
    _, params, opt = abstract_train_state(tc, kernels="torch")
    _, step = make_train_step(tc, kernels="torch")
    _, got = count_call(step, params, opt,
                        input_specs(tc, ShapeCell("t", S, B, "train"))[0])
    if tol is None:
        assert got["flops"] == want
    else:
        assert abs(got["flops"] / want - 1) <= tol, got["flops"] / want
    assert got["flops_by_dtype"]["bfloat16"] > got["flops_by_dtype"].get(
        "float32", 0) > 0
    assert got["bytes"] > 0 and got["aten_ops"] > 0
