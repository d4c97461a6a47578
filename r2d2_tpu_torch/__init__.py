"""PyTorch/CUDA port of r2d2_tpu for one NVIDIA H100.

A package of its own beside the JAX reference (`r2d2_tpu/`), with the same
module names so each counterpart is easy to find. It imports `torch` and
`numpy`, never JAX or anything of the JAX package.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on a CUDA tensor every kernel wrapper launches its
hand-written Hopper kernel (csrc/) or raises, and on a CPU tensor it runs
the kernel's plain PyTorch version.
"""
