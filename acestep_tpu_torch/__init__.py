"""acestep_tpu_torch — the PyTorch/CUDA port of the ACE-Step engine for NVIDIA
Hopper (H100).

The JAX package ``acestep_tpu`` beside it is the reference; this package
imports nothing from it and never imports JAX.  It covers text2music at
batch 1 with q8_0, q4_0, q4_k or q6_k weights: Qwen3 text encoder -> 8-step
turbo DiT -> Oobleck VAE decode to int16, from random weights or a converted
checkpoint directory (``serving.launch.build_engine``), behind the JAX
package's REST and OpenRouter servers (``python -m
acestep_tpu_torch.serving.launch api|openrouter``).  Its hot ops are
hand-written CUDA C++ kernels for sm_90a (``csrc/*.cu``), built with plain
``nvcc`` calls (one per source, in parallel) and loaded with ctypes:

  ops.cuda.qmm          dequant-matmul for q8_0, q4_0, q4_k and q6_k (2-D and
                        layer-stacked weights; csrc/qmm_wgmma.cu)
  ops.cuda.vae_resunit  fused Oobleck residual unit and dilation-1/3/9 trio

Every kernel wrapper runs the kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (the CPU tests); it never falls back from one to the
other.  Entry points default to ``device="cuda"``.
"""

__version__ = "0.1.0"
