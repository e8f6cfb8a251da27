"""litbox_tpu_torch: the PyTorch/CUDA port of litbox_tpu for one NVIDIA H100.

The JAX package `litbox_tpu` stays as the reference; this package imports
neither it nor JAX. It keeps the JAX package's layout:
  core/   types, LUT builders (a copy), texture sampling
  scene/  scene builder and GBuffer rasterizer
  sim/    the rotated-bin transport (RBT): fields, trace, exact collimated
          fields, resolve, HDR; the oracle march; the tracers
  ops/    the hand-written CUDA kernels (csrc/*.cu) with their plain
          versions; the deposit splats
  post/   tone maps and their inverse, tracer-pair post-processing
  nn/     the denoiser UNet (inference and training), its losses, the
          datasets and on-device batches, the Trainer with its checkpoints,
          tiled inference and the blends, export (reference .pth,
          TorchScript, ONNX), the training display
  io/     the EXR codec (a copy of the JAX package's) and PNG helpers
  native/ the host's multithreaded EXR decoder (C++, built with g++ at
          first use, loaded with ctypes)
  engine/ Simulation (the user's entry point), AIAccelerator, the fused
          pipeline and the shipped realtime frame
  parallel/ the scaling design on torch.distributed: the data-parallel
          oracle and RBT, the bin-sharded RBT, the sharded training step,
          and the runner that starts the ranks
  convert.py  carries state across from the JAX package as numpy dicts,
          and the UNet's weights back to Flax's layout

    from litbox_tpu_torch.engine import Simulation, Mode
    from litbox_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add_point_light((128, 140), radius=4, color=(1, .85, .6), intensity=2, bounces=3)
    sim = Simulation(width=256, height=256, mode=Mode.REFERENCE)
    sim.set_scene(b.build())   # on "cuda"; device="cpu" for both on the CPU
    hdr = sim.run()

Training: `nn.train.Trainer(TrainConfig())` trains on `cuda` (the JAX
package's recipes, optimizer and npz checkpoints, which either package
loads), and `engine.pipeline.AIAccelerator.from_checkpoint` hosts the
result on a Simulation.

Entry points build tensors on `cuda` unless the caller passes `device="cpu"`;
functions that take tensors run where their inputs lie. On a CPU tensor a
kernel wrapper runs its plain PyTorch version; on a CUDA tensor it launches
the kernel or raises.
"""

__version__ = "0.1.0"
