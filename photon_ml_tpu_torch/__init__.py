"""photon_ml_tpu_torch: the PyTorch and CUDA port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` stays the reference; this package imports
neither it nor JAX. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``. Ported so far: fixed-effect GLM training on dense
features (``game.problem.GLMProblem.run`` with TRON or L-BFGS), scoring and
AUC, and the GLMix coordinate-descent sweep (``game``), on one card or
data-parallel over ``torch.distributed`` ranks (``parallel``), with the
dense value+gradient, Hessian-vector and Hessian-statistics sweeps as
hand-written CUDA kernels (``csrc/fused_glm.cu``).
"""

__version__ = "0.1.0"
