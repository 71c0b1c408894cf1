"""The port's own copies of ``mfx/data``'s numpy modules (``coo``,
``synthetic``, ``loaders``, ``split``; verbatim but for their import
lines) and the BPR sampler (``bpr``), so that the port imports nothing of
the JAX package. ``tests/test_torch_config_data.py`` holds the copies to
the originals."""

from mfx_torch.data.coo import RatingsCOO, SeenCSR
from mfx_torch.data.loaders import dataset_names, load_dataset
from mfx_torch.data.split import (chronological_split, epoch_permutation,
                                  leave_one_out_split, train_test_split,
                                  user_chronological_split)
from mfx_torch.data import synthetic

__all__ = [
    "RatingsCOO", "SeenCSR", "load_dataset", "dataset_names",
    "train_test_split", "chronological_split", "user_chronological_split",
    "leave_one_out_split", "epoch_permutation", "synthetic",
]
