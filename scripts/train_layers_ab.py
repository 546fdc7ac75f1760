"""One qwen2-0.5b training step on the card (full width and depth, batch
4 x 1,024, bf16 compute over float32 parameters, the ``cuda`` route) with
the models' stacked ``[L, ...]`` leaves unbound once a forward
(``models.model._layers``, the port's way) against sliced one layer at a
time (``tree[l]``, whose gradient is scattered into a zero tensor of the
whole stack a layer), in turns within one process: (unbound, sliced,
sliced, unbound), each six steps timed on the host clock around a
synchronized step, then one step under the profiler (device busy ms and
kernels a step).

    python3 scripts/train_layers_ab.py

Nothing of the port imports this script.
"""
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import repro_torch.models.model as M                        # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.data import TokenStream                    # noqa: E402
from repro_torch.kernels.build import library               # noqa: E402
from repro_torch.launch.train import make_train_step        # noqa: E402
from repro_torch.optim import adamw_init                    # noqa: E402


def sliced(tree):
    """Every layer's slice of the stacked leaves, one ``tree[l]`` each."""
    def one(t, l):
        if isinstance(t, dict):
            return {k: one(v, l) for k, v in t.items()}
        return t[l]
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [one(tree, l) for l in range(first.shape[0])]


def main():
    library()
    dev = torch.device("cuda")
    unbound = M._layers
    cfg = get_config("qwen2-0.5b")
    model, step = make_train_step(cfg, lr=3e-4, kernels="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    batch = TokenStream(cfg, 4, 1024, device=dev).next()
    order = (("unbind", unbound), ("slice", sliced), ("slice", sliced),
             ("unbind", unbound))
    for name, fn in order:
        M._layers = fn
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, opt, batch)
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
        busy = sum(getattr(e, "device_time", 0) for e in ev) / 1e3
        print(f"{name}: steps ms {[round(t * 1e3, 1) for t in ts]}, median "
              f"{sorted(ts[1:])[2] * 1e3:.1f}; profiled busy {busy:.1f} ms,"
              f" {len(ev)} kernels", flush=True)
    M._layers = unbound


if __name__ == "__main__":
    main()
