"""Serving of the PyTorch port: the prefill/decode step factories and the
``Server`` with PostSI-versioned weights (counterpart of
``repro.launch``)."""
