"""Model plane of the PyTorch port: configs, parameter specs, layers, the
Mamba2 mixer and the models of every family -- decoder (dense, MoE, VLM),
SSM, hybrid (zamba2) and encoder-decoder (counterpart of
``repro.models``)."""
