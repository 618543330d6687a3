"""acestep_tpu_torch — the PyTorch/CUDA port of the ACE-Step engine for NVIDIA
Hopper (H100).

The JAX package ``acestep_tpu`` beside it is the reference; this package
imports nothing from it and never imports JAX.  The first slice covers q8_0
text2music: Qwen3 text encoder -> 8-step turbo DiT -> Oobleck VAE decode to
int16.  Its hot ops are hand-written CUDA C++ kernels for sm_90a
(``csrc/*.cu``), built with one plain ``nvcc`` call and loaded with ctypes:

  ops.cuda.qmm          q8_0 dequant-matmul (2-D and layer-stacked weights)
  ops.cuda.vae_resunit  fused Oobleck residual unit and dilation-1/3/9 trio

Every kernel wrapper runs the kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (the CPU tests); it never falls back from one to the
other.  Entry points default to ``device="cuda"``.
"""

__version__ = "0.1.0"
