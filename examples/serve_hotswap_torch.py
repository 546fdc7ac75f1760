"""Serving with live weight hot-swap under PostSI, on the PyTorch port.

The counterpart of ``examples/serve_hotswap.py`` for ``repro_torch``.  A
server answers batched decode requests while a publisher transaction
commits new weight versions concurrently.  Each request batch is a reader
transaction over the versioned weight store: Consistent Visibility
guarantees every batch sees exactly ONE weight version -- reading layer 0
of version k and layer 1 of version k+1 ("torn" weights) is the
partial-visibility anomaly CV forbids.

We verify: every served batch reports a single consistent version tag, even
though publishes interleave with serving, and a half-written publish stays
invisible until it commits.

Run:  PYTHONPATH=src python examples/serve_hotswap_torch.py
      (on the CUDA device; ``--device cpu`` runs the plain PyTorch route)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.seq import SeqScheduler
from repro_torch.kernels import resolve_device
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.train import make_decode_step, make_prefill_step
from repro_torch.models.module import tree_leaves

B, S, NEW = 4, 16, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_reduced("qwen2-0.5b").replace(vocab_size=512)
    model, prefill = make_prefill_step(cfg)
    _, decode = make_decode_step(cfg)

    # weight versions: v0, v1 and v2 (e.g. fresh finetunes published
    # mid-serving)
    params_v = [model.init(torch.Generator(device=dev).manual_seed(i))
                for i in range(3)]
    n_leaves = len(tree_leaves(params_v[0]))

    # the versioned store: one key per weight leaf; value = version id
    sched = SeqScheduler(n_leaves, mode="postsi")
    pub = sched.begin()
    for k in range(n_leaves):
        sched.write(pub, k, 0)
    assert sched.commit(pub)

    def publish(version: int, upto: int | None = None):
        """Writer txn; ``upto`` leaves a publish half-done (in flight)."""
        t = sched.begin()
        for k in range(n_leaves if upto is None else upto):
            sched.write(t, k, version)
        return t

    def serve_batch(batch_id: int) -> int:
        """Reader txn: assemble the weights leaf by leaf from the store."""
        t = sched.begin()
        versions = [sched.read(t, k) for k in range(n_leaves)]
        assert sched.commit(t)
        vs = set(versions)
        assert len(vs) == 1, f"TORN WEIGHTS in batch {batch_id}: {vs}"
        v = versions[0]
        params = params_v[v]
        batch = make_batch(cfg, B, S, "prefill",
                           rng=np.random.RandomState(batch_id), device=dev)
        # the cache has room for the new tokens
        logits, cache = prefill(params, batch, S + NEW)
        tok = logits[..., :cfg.vocab_size].argmax(dim=-1).int()
        for _ in range(NEW):                    # a few decode steps
            tok, cache = decode(params, cache, {"token": tok})
        return v

    print(f"serving 8 batches with two interleaved weight publishes on "
          f"{dev}...")
    served = [serve_batch(0), serve_batch(1)]
    inflight = publish(1, upto=n_leaves // 2)   # publisher writes half...
    served.append(serve_batch(2))               # ...reader must still see v0
    for k in range(n_leaves // 2, n_leaves):
        sched.write(inflight, k, 1)
    assert sched.commit(inflight)               # v1 becomes visible atomically
    served += [serve_batch(3), serve_batch(4)]
    assert sched.commit(publish(2))
    served += [serve_batch(5), serve_batch(6), serve_batch(7)]

    print("weight version per batch:", served)
    assert served[:3] == [0, 0, 0] and served[3] == 1 and served[-1] == 2
    print("OK: every batch saw one atomic weight version; the half-published "
          "update was invisible until its commit (no torn weights).")
    return served


if __name__ == "__main__":
    main()
