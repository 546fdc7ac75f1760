"""Model plane of the PyTorch port: configs, parameter specs, layers, the
Mamba2 mixer and the hybrid (zamba2) model (counterpart of
``repro.models``)."""
