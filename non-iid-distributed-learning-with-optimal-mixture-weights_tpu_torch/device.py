"""Where the port runs: on a CUDA card unless the caller names the CPU.

Every entry point that places data (``prepare_setup``,
``convert.setup_from_arrays``) resolves its ``device`` argument here.
``None`` means the card; with no card it raises instead of carrying on
quietly on the CPU, so a run can never report CPU numbers as the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:i]"``/``torch.device``
    as given. Raises ``RuntimeError`` when CUDA is asked for (explicitly
    or by default) and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fedamw_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
