"""Where the port's tensors live.

The port runs on the card.  The CPU is used only when a caller asks for
it by name (the tests pass ``device="cpu"``); a missing card is an error,
never a quiet fall-back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda:0``.

    Raises :class:`RuntimeError` when ``None`` is given and no CUDA card
    is present.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sitewhere_tpu_torch runs on a CUDA card and none is present; "
            "pass device='cpu' explicitly to run the plain versions")
    return torch.device("cuda", 0)
