"""mfx_torch — the PyTorch/CUDA port of mfx.

The JAX package ``mfx`` is the reference; this package mirrors its module
names (``config``, ``data``, ``models.mf``, ``kernels.*``, ``solvers.*``,
``parallel.bpr_sharded``, ``eval.*``, ``train.*``, ``serve.*``,
``oracle``, ``cli``) and imports nothing of it, nor JAX: ``config``,
``data`` and ``oracle`` are its own copies of the reference's NumPy-only
modules.

The hot paths (the blocked-SGD epoch, the BPR ring epoch and fused
serving) run hand-written CUDA kernels, built from ``mfx_torch/csrc``
with ``nvcc`` at first use (``mfx_torch.kernels._build``). Each kernel's
wrapper runs a plain PyTorch version of the same function when its
tensors lie on the CPU. The minibatch SGD step, which the reference runs
through XLA, is stock torch ops (``kernels.minibatch``).
"""

from mfx_torch.models.mf import MFModel, init_model

__all__ = ["MFModel", "init_model"]
