"""wavetpu_torch - the PyTorch/CUDA port of wavetpu for one NVIDIA H100.

A second package beside `wavetpu/` (the JAX reference it is held against).
It imports `torch` and numpy, never `jax` and nothing of `wavetpu`: the
few jax-free modules it needs (`core.problem`, `core.flags`) are its own
copies.  Every Pallas kernel on the ported path is a hand-written CUDA
kernel for sm_90a (`kernels/csrc/`), with a plain PyTorch version beside
it that the CPU runs (`kernels/stencil_cuda.py`).

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"` in the library, `--platform cpu` on the CLI).
"""

from wavetpu_torch.core.problem import Problem, parse_length

__version__ = "0.1.0"

__all__ = ["Problem", "parse_length", "__version__"]
