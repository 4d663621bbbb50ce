"""PyTorch/CUDA port of the node-aware SpMV (one GPU, ranks as a batch axis).

Entry point: :func:`repro_torch.api.operator`.  The port imports neither
JAX nor the JAX package; it keeps its own copy of the host layer.
"""
