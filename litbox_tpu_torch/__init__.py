"""litbox_tpu_torch: the PyTorch/CUDA port of litbox_tpu for one NVIDIA H100.

The JAX package `litbox_tpu` stays as the reference; this package imports
neither it nor JAX. It keeps the JAX package's layout:
  core/   types, LUT builders (a copy), texture sampling
  scene/  scene builder and GBuffer rasterizer
  sim/    the rotated-bin transport (RBT) frame: fields, trace, resolve, HDR
  ops/    the hand-written CUDA kernels (csrc/*.cu) with their plain versions
  convert.py  carries state across from the JAX package as numpy dicts

Entry points build tensors on `cuda` unless the caller passes `device="cpu"`;
functions that take tensors run where their inputs lie. On a CPU tensor a
kernel wrapper runs its plain PyTorch version; on a CUDA tensor it launches
the kernel or raises.
"""

__version__ = "0.1.0"
