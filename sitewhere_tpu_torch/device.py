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

    Raises :class:`RuntimeError` when the device is a CUDA one (``None``
    included) and no CUDA card is present.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"sitewhere_tpu_torch runs on a CUDA card ({dev}) and no CUDA "
            "card is present; pass device='cpu' (--device cpu) explicitly "
            "to run the plain versions")
    return dev
