"""The input-shape cells of the LM-family architectures (port of
``repro.configs.shapes``).

``decode_*`` / ``long_*`` run ``make_decode_step`` (one new token against
a KV cache / recurrent state of ``seq_len``); ``train_4k`` runs
``make_train_step``; ``prefill_32k`` runs ``make_prefill_step``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic sequence handling: SSM and hybrid families
# only; the full-attention families skip it
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(family: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return family in LONG_OK_FAMILIES
    return True
