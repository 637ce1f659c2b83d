"""Objective-level ops: losses, normalization, dense and sparse features,
the GLM objective and the CUDA kernels under it (the fused dense sweeps and
the sparse segment kernel)."""
