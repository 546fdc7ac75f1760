"""PostSI / Consistent Visibility in PyTorch: the port of the ``repro``
package to PyTorch and hand-written CUDA kernels for an NVIDIA H100.

Decentralized MVCC: transactions negotiate logical time intervals from
visibility relationships; no central clock exists anywhere in this
package.  It imports neither ``jax`` nor ``repro``; its tests hold it
against ``repro`` on identical inputs.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
