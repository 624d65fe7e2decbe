"""Label generation service: QR symbology for platform entities.

Counterpart of ``sitewhere_tpu/labels/manager.py``, whole.

Reference: ``service-label-generation`` exposes named label generators
(``labels/symbology/LabelGeneratorManager.java``) and a QR generator
(``labels/symbology/QrCodeGenerator.java``) that renders an entity URL into
a PNG served over gRPC/REST.  Here a generator is a URL template + render
options; the symbology itself is :mod:`sitewhere_tpu_torch.labels.qr` and batched
rendering is a vectorized upscale so large label runs (bench config 5) are
one array op instead of a per-label image pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.labels import png, qr
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.services.common import EntityNotFound, require

# Entity kinds the reference builds label URLs for (device, assignment,
# area, customer, asset — cf. the label REST surface in service-web-rest).
ENTITY_KINDS = ("device", "assignment", "area", "customer", "asset", "tenant")


@dataclasses.dataclass
class LabelGenerator:
    """A named QR label generator (reference ``ILabelGenerator``)."""

    generator_id: str
    name: str
    url_template: str = "https://sitewhere-tpu.local/{kind}/{token}"
    scale: int = 4          # pixels per module
    border: int = 4         # quiet-zone modules (spec minimum)
    ec_level: str = "M"

    def url_for(self, kind: str, token: str) -> str:
        require(kind in ENTITY_KINDS, EntityNotFound(f"unknown entity kind {kind!r}"))
        return self.url_template.format(kind=kind, token=token)


def render_modules(matrix: np.ndarray, scale: int = 4, border: int = 4) -> np.ndarray:
    """Upscale a module matrix to a grayscale image (0=dark ink, 255=light)."""
    bordered = np.pad(matrix, border, constant_values=0)
    img = np.where(bordered > 0, 0, 255).astype(np.uint8)
    return np.kron(img, np.ones((scale, scale), dtype=np.uint8))


def render_batch(matrices: Sequence[np.ndarray], scale: int = 4,
                 border: int = 4) -> np.ndarray:
    """Render many same-version QR matrices in one vectorized op.

    Returns ``uint8[B, H, W]``.  All matrices must share one size (encode
    with an explicit ``version`` to guarantee this); the upscale is a single
    broadcasted kron over the batch, the array-friendly path the mixed
    label/media benchmark exercises.
    """
    sizes = {m.shape[0] for m in matrices}
    if len(sizes) != 1:
        raise ValueError(f"mixed matrix sizes {sorted(sizes)}; pin a version")
    stack = np.stack(matrices)
    bordered = np.pad(stack, ((0, 0), (border, border), (border, border)),
                      constant_values=0)
    img = np.where(bordered > 0, 0, 255).astype(np.uint8)
    return np.kron(img, np.ones((1, scale, scale), dtype=np.uint8))


class LabelGeneratorManager(LifecycleComponent):
    """Registry of label generators (reference ``LabelGeneratorManager``)."""

    def __init__(self, generators: Optional[List[LabelGenerator]] = None):
        super().__init__("label-generation")
        self._generators: Dict[str, LabelGenerator] = {}
        # Degradation ladder (runtime/overload.py): when wired, label
        # rendering — optional, CPU-bound work — refuses with 503 from
        # DEGRADED up so its cycles go to the event path instead.
        self.load_gate = None   # Callable[[str], bool] | None
        self.refused_under_load = 0
        for gen in generators or [LabelGenerator("default", "Default QR")]:
            self.register(gen)

    def register(self, generator: LabelGenerator) -> LabelGenerator:
        self._generators[generator.generator_id] = generator
        return generator

    def _check_capacity(self) -> None:
        if self.load_gate is not None and not self.load_gate("labels"):
            from sitewhere_tpu_torch.services.common import ServiceUnavailable

            self.refused_under_load += 1
            raise ServiceUnavailable(
                "label generation is switched off while the instance "
                "is overloaded; retry after it recovers")

    def get_generator(self, generator_id: str) -> LabelGenerator:
        gen = self._generators.get(generator_id)
        require(gen is not None, EntityNotFound(f"no label generator {generator_id!r}"))
        return gen

    def list_generators(self) -> List[LabelGenerator]:
        return list(self._generators.values())

    def generate_matrix(self, generator_id: str, kind: str, token: str) -> np.ndarray:
        self._check_capacity()
        gen = self.get_generator(generator_id)
        return qr.encode(gen.url_for(kind, token), level=gen.ec_level)

    def generate_png(self, generator_id: str, kind: str, token: str) -> bytes:
        """Entity label as PNG bytes — the REST/gRPC payload of the reference
        (``service-label-generation/.../grpc/LabelGenerationImpl.java``)."""
        self._check_capacity()
        gen = self.get_generator(generator_id)
        matrix = self.generate_matrix(generator_id, kind, token)
        return png.write_png(render_modules(matrix, gen.scale, gen.border))

    def generate_png_batch(self, generator_id: str, kind: str,
                           tokens: Sequence[str]) -> List[bytes]:
        """Batch label run: encode each token, render all in one upscale."""
        self._check_capacity()
        gen = self.get_generator(generator_id)
        payloads = [gen.url_for(kind, t) for t in tokens]
        version = max(
            qr.pick_version(len(p.encode("utf-8")), gen.ec_level) for p in payloads
        )
        matrices = [qr.encode(p, level=gen.ec_level, version=version)
                    for p in payloads]
        images = render_batch(matrices, gen.scale, gen.border)
        return [png.write_png(img) for img in images]
