"""Public wrapper for the grouped matmul: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.

``launches`` counts the kernel launches this process made through ``gmm``;
a run resets it to 0 and reads it back to show that its main path went
through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .kernel import grouped_matmul
from .ref import grouped_matmul_ref

__all__ = ["gmm", "launches"]

launches = 0
_count_lock = threading.Lock()


def gmm(
    x: torch.Tensor,            # (E, C, d)
    w: torch.Tensor,            # (E, d, f)
    group_sizes: torch.Tensor,  # (E,) int32
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None,
) -> torch.Tensor:
    """Grouped matmul over capacity bins (see ``ref.grouped_matmul_ref``).

    A CUDA tensor launches the kernel or raises; only a tensor that lies on
    the CPU takes the plain version.  ``events`` time the launch (see
    ``kernel.grouped_matmul``); the plain version takes none.
    """
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, group_sizes)
    out = grouped_matmul(x, w, group_sizes, events)
    if out.numel():  # an empty output launches nothing
        with _count_lock:
            launches += 1
    return out
