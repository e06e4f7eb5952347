"""neko_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of neko_tpu.

The package mirrors `neko_tpu`'s layout and names, so each module's JAX
counterpart sits at the same path under `neko_tpu/`.  It imports torch and
numpy only, never JAX or the JAX package: the machines that run it need not
have JAX installed.  The hand-written CUDA kernels live in `csrc/` and are
compiled with nvcc at first use (see ops/cuda_build.py).
"""

from neko_tpu_torch.config import ModelConfig, TokenSpace

__all__ = ["ModelConfig", "TokenSpace"]
