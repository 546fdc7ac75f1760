"""End-to-end training driver of the PyTorch port: a small LM on the
synthetic token language, with PostSI-committed checkpoints, an injected
node failure mid-run, and automatic restore/resume (the port of
``examples/train_lm.py``, with the same arguments and asserts).

On the card (the default device) the gradients of attention and of the
SSD scan run the hand-written backward kernels (every ``--arch``, the SSM
and hybrid families included); ``--device cpu`` runs the plain ``torch``
route.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      [--arch qwen2-0.5b] [--device cpu]
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import PostSICheckpointer
from repro_torch.configs import get_reduced
from repro_torch.data import TokenStream
from repro_torch.kernels import resolve_device
from repro_torch.launch.train import make_train_step
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.runtime import FailureInjector, TrainRunner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fail-at", type=int, default=77,
                    help="inject a node failure at this step (-1: off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch).replace(vocab_size=2048)
    model, step_fn = make_train_step(cfg, lr=args.lr)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"batch={args.batch}x{args.seq} device={dev}")

    stream = TokenStream(cfg, args.batch, args.seq, seed=0, device=dev)
    ckdir = tempfile.mkdtemp(prefix="postsi_ckpt_")
    tree_ex = {"params": params, "opt": opt,
               "data": {"step": torch.tensor(0, dtype=torch.int32)}}
    ck = PostSICheckpointer(ckdir, tree_ex)

    runner = TrainRunner(step_fn, stream, ck, ckpt_every=25)
    injector = FailureInjector(
        fail_at=() if args.fail_at < 0 else (args.fail_at,))

    out = runner.run(params, opt, args.steps, injector=injector)
    ls = out["losses"]
    print(f"\nsteps={out['final_step']} restarts={out['restarts']} "
          f"(injected failure {'fired' if out['restarts'] else 'off'})")
    for i in range(0, len(ls), max(len(ls) // 10, 1)):
        print(f"  step {i:4d}  loss {ls[i]:.4f}")
    print(f"  final loss {ls[-1]:.4f}  (start {ls[0]:.4f})")
    assert ls[-1] < ls[0], "loss should decrease"
    shutil.rmtree(ckdir, ignore_errors=True)
    print("OK: trained through an injected failure with PostSI checkpoints.")


if __name__ == "__main__":
    main()
