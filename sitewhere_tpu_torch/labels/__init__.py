"""Label generation: QR symbology + PNG rendering for platform entities.

Counterpart of ``sitewhere_tpu/labels/__init__.py``, whole.

TPU-new implementation of the reference ``service-label-generation``
(``labels/symbology/QrCodeGenerator.java``, ``LabelGeneratorManager.java``).
"""

from sitewhere_tpu_torch.labels.manager import (  # noqa: F401
    LabelGenerator,
    LabelGeneratorManager,
    render_batch,
    render_modules,
)
from sitewhere_tpu_torch.labels.png import read_png_size, write_png  # noqa: F401
from sitewhere_tpu_torch.labels.qr import decode_matrix, encode  # noqa: F401
