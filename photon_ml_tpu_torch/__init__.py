"""photon_ml_tpu_torch: the PyTorch and CUDA port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` stays the reference; this package imports
neither it nor JAX. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``. Ported so far: fixed-effect GLM training on dense,
ELL and sorted-COO features (``game.problem.GLMProblem.run`` with TRON,
L-BFGS, OWL-QN or L-BFGS-B), scoring and AUC, and the GLMix
coordinate-descent sweep (``game``), on one card or, with dense features,
data-parallel over ``torch.distributed`` ranks (``parallel``), with the
dense value+gradient, Hessian-vector and Hessian-statistics sweeps
(``csrc/fused_glm.cu``), the sparse products (``csrc/sparse_glm.cu``) and
the vmapped random-effect solve's lane reduction (``csrc/lane_reduce.cu``)
as hand-written CUDA kernels; and the data and model IO (``io``, the
native Avro decoder ``native``) with the legacy GLM driver (``cli.glm``).
"""

__version__ = "0.1.0"
