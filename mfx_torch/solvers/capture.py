"""A minibatch trainer's batch loop captured as a CUDA graph, shared by
``solvers.sgd`` (the SGD epoch) and ``solvers.bpr`` (the snapshot BPR
epoch, which the BPR ring's ``'jnp'`` path also runs).

The reference scans an epoch's batches as one XLA program. On the card
the port captures one batch's step once as a CUDA graph that reads batch
``k`` of static epoch buffers and advances ``k`` itself, so an epoch is a
copy of its batches into the buffers and one replay a batch: the same
kernels on the same data as the eager loop, without its host dispatch of
every op and with no host sync.
"""

from __future__ import annotations

from typing import Callable

import torch

from mfx_torch.kernels.packing import GRAPH_LAUNCHES, bf16_row_add

__all__ = ["CapturedLoop"]


class CapturedLoop:
    """``step(batch)`` captured over static buffers shaped like ``like``
    (a ``(num_batches, ...)`` tensor per input; ``batch`` holds one row
    of each). The buffers hold a quarter more batches than ``like``, and
    16 more: the warm-up's second call reads batch 1, which an epoch of
    one batch lacks, and a later epoch of a few more batches reuses the
    graph. ``step`` must leave its state as it was when it runs on zero
    buffers (the warm-up runs it twice off the capture), and keep
    referenced every tensor it reads: the graph holds their addresses.

    ``bf16_row_add`` launches recorded into the graph are counted in
    ``GRAPH_LAUNCHES['captured']``, and each replay's in
    ``GRAPH_LAUNCHES['replayed']``."""

    def __init__(self, step: Callable[[dict], object], like: dict,
                 device: torch.device):
        nb = next(iter(like.values())).shape[0]
        self.cap = nb + nb // 4 + 16
        self.bufs = {k: torch.zeros((self.cap,) + tuple(v.shape[1:]),
                                    dtype=v.dtype, device=device)
                     for k, v in like.items()}
        self.k = torch.zeros(1, dtype=torch.int64, device=device)

        def body():
            step({k: v.index_select(0, self.k)[0]
                  for k, v in self.bufs.items()})
            self.k.add_(1)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = bf16_row_add.launches
        with torch.cuda.graph(self.graph):
            body()
        self.row_adds = bf16_row_add.launches - before  # a replay's
        GRAPH_LAUNCHES["captured"] += self.row_adds

    def fits(self, batches: dict) -> bool:
        """Whether ``batches`` has this loop's inputs, their row shapes
        and dtypes, and at most as many batches as the buffers hold."""
        return batches.keys() == self.bufs.keys() and all(
            v.shape[0] <= self.cap and v.shape[1:] == self.bufs[k].shape[1:]
            and v.dtype == self.bufs[k].dtype for k, v in batches.items())

    def run(self, batches: dict) -> None:
        """Copy ``batches`` into the buffers and replay the step once a
        batch, in order."""
        nb = next(iter(batches.values())).shape[0]
        for k, v in batches.items():
            self.bufs[k][:nb].copy_(v)
        self.k.zero_()
        for _ in range(nb):
            self.graph.replay()
        GRAPH_LAUNCHES["replayed"] += self.row_adds * nb
