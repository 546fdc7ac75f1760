"""Dry run of every architecture x shape cell on one H100, counted on the
``meta`` device (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a,b]
        [--shape s,t] [--route cuda|torch] [--outdir DIR] [--tag T]

Each cell builds its step as a user would (``make_train_step`` with
``abstract_train_state``, ``make_prefill_step`` or ``make_decode_step``;
the serve cells with ``param_dtype=torch.bfloat16``, as the reference's
dry run serves) over ``input_specs`` and runs it once on ``meta`` under
``launch.op_count.OpCounter``: nothing is allocated or computed, so a
full-size step counts on a machine with no card.  On the ``cuda`` route
(the default) each hand-written kernel is counted by its own cost
formula, as the card would launch it.  The record keeps the reference's
keys where they mean something on one card: ``count`` in place of
``hlo`` (FLOPs by dtype, bytes, aten ops, kernel launches), ``memory``
(argument, output and peak-live bytes), ``roofline`` against the H100
SXM's peaks (``kernels.roofline``: ``compute_s``, ``memory_s``,
``collective_s`` 0, ``dominant``, ``useful_flops_frac`` = MODEL_FLOPS
over the counted FLOPs) and ``fits_one_card`` (peak-live bytes within
the card's 80 GB).  A cell not applicable to its family (``long_500k``
for the full-attention families) is a record with ``skipped``.

The reference's ``--mesh``, ``--seq-shard-kv`` and ``--remat`` steer
GSPMD over TPU pod meshes and XLA's rematerialization; they have no
counterpart on one card and are not taken (the port remats per layer, as
the reference's default policy does).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.kernels.roofline import HBM_BYTES, HBM_BYTES_PER_S
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.op_count import compute_seconds, count_call
from repro_torch.launch.train import (abstract_train_state, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.module import abstract

__all__ = ["model_flops", "roofline", "run_cell", "main"]


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # decode: 1 token/seq


def roofline(count: Dict[str, Any], useful_flops=None) -> Dict[str, Any]:
    """The least time one H100 takes for the counted work: the products at
    their dtypes' rates, the bytes at the HBM rate, no collectives."""
    compute_s = compute_seconds(count["flops_by_dtype"])
    memory_s = count["bytes"] / HBM_BYTES_PER_S
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", 0.0)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": 0.0, "dominant": dominant,
            "useful_flops_frac": (useful_flops / count["flops"]
                                  if useful_flops and count["flops"]
                                  else None)}


def record(count: Dict[str, Any], **keys) -> Dict[str, Any]:
    """A dry-run record of one counted call: ``keys``, the count without
    its memory, the memory, and whether its peak fits one card."""
    memory = count["memory"]
    return {**keys, "n_devices": 1,
            "count": {k: v for k, v in count.items() if k != "memory"},
            "memory": memory,
            "fits_one_card": memory["peak_live_bytes"] <= HBM_BYTES}


def run_cell(arch: str, shape_name: str, route: str = "cuda"
             ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not applicable(cfg.family, shape_name):
        return {"arch": arch, "shape": shape_name,
                "skipped": f"long_500k not applicable to family={cfg.family} "
                           "(full attention; see DESIGN.md §5)"}
    t0 = time.time()
    if shape.kind == "train":
        _, params, opt = abstract_train_state(cfg, kernels=route)
        _, step = make_train_step(cfg, kernels=route)
        _, count = count_call(step, params, opt, input_specs(cfg, shape)[0])
    else:
        scfg = cfg.replace(param_dtype=torch.bfloat16)
        make = make_prefill_step if shape.kind == "prefill" \
            else make_decode_step
        model, step = make(scfg, kernels=route)
        params = abstract(model.param_specs())
        if shape.kind == "prefill":
            _, count = count_call(step, params, input_specs(scfg, shape)[0])
        else:
            batch, cache = input_specs(scfg, shape)
            _, count = count_call(step, params, cache, batch)
    mf = model_flops(cfg, shape)
    rec = record(count, arch=arch, shape=shape_name, kind=shape.kind,
                 route=route, count_s=round(time.time() - t0, 1),
                 model_flops_global=mf)
    rec["roofline"] = roofline(count, mf)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--route", default="cuda", choices=("cuda", "torch"))
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.outdir, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            name = f"{arch}__{shape}__h100{args.tag}"
            path = os.path.join(args.outdir, name + ".json")
            if os.path.exists(path):
                print(f"[skip] {name} (exists)")
                continue
            print(f"[cell] {name} ...", flush=True)
            rec = run_cell(arch, shape, args.route)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if "roofline" in rec:
                r = rec["roofline"]
                print(f"  ok count={rec['count_s']}s dominant={r['dominant']}"
                      f" c={r['compute_s']:.4f}s m={r['memory_s']:.4f}s "
                      f"peak={rec['memory']['peak_live_bytes'] / 1e9:.1f} GB"
                      f" fits={rec['fits_one_card']}", flush=True)
            else:
                print(f"  skipped: {rec['skipped']}", flush=True)


if __name__ == "__main__":
    main()
