"""stereoformer_tpu_torch: the PyTorch and CUDA port of stereoformer_tpu.

The package mirrors the JAX package's module names (``ops``, ``nn``,
``models``, ``losses``, ``metrics``, ``train``, ``data``, ``cli``) and
keeps its public layouts: images NHWC
``[B, H, W, 3]``, cost volumes ``[B, H, W, D]`` with D innermost, and
disparities ``[B, H, W, 1]``. The kernels that the JAX package wrote in
Pallas for the TPU are CUDA kernels written for Hopper (``csrc/``, built by
``kernels.py`` at first use). Entry points run on the GPU unless the caller
asks for the CPU.

It imports torch and numpy, and nothing of JAX or of ``stereoformer_tpu``.
Import is light: submodules load on demand.
"""

__version__ = "0.1.0"
