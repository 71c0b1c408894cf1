"""mfx_torch — the PyTorch/CUDA port of mfx.

The JAX package ``mfx`` is the reference; this package mirrors its module
names (``models.mf``, ``kernels.packing``, ``kernels.plan_device``,
``solvers.dense_prep``, ``solvers.blocked``, ``eval.metrics``,
``train.driver``, ``cli``) and shares only the NumPy-only ``mfx.config``
and ``mfx.data``. It never imports JAX.

The hot path (the blocked-SGD epoch) runs two hand-written CUDA kernels,
built from ``mfx_torch/csrc`` with ``nvcc`` at first use
(``mfx_torch.kernels._build``). Each kernel's wrapper runs a plain PyTorch
version of the same function when its tensors lie on the CPU.
"""

from mfx_torch.models.mf import MFModel, init_model

__all__ = ["MFModel", "init_model"]
