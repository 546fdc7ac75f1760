"""Launch tooling of the PyTorch port (counterpart of ``repro.launch``):
the train / prefill / decode step factories, the ``Server`` with
PostSI-versioned weights, the input batches and specs, and the dry run
that counts a step's work (``op_count``, ``dryrun``, ``dryrun_postsi``)."""
