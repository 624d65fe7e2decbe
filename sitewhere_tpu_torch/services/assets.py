"""Asset management — the asset catalog bound to device assignments.

Reference: ``service-asset-management`` implements ``IAssetManagement``
(``sitewhere-core-api/.../spi/asset/IAssetManagement.java:25-135``): asset
types (category person/device/hardware) and assets, referenced by device
assignments (``DeviceAssignment.asset_id``) so events can be enriched with
"who/what this device is attached to".  (The reference's bulk of LoC is a
generated WSO2 SOAP client — an external identity-provider integration we
deliberately do not replicate; the capability is the catalog + binding.)

Counterpart of ``sitewhere_tpu/services/assets.py``, whole.  Assets are
host-only records; the pipeline sees only the dense ``asset_id`` column
already present in :class:`~sitewhere_tpu_torch.schema.Registry` —
binding an asset to an assignment flows through ``DeviceManagement`` into
the registry epoch.  The entity classes name the reference's in
``_PICKLE_AS``, so the checkpoint's ``stores`` section reads the same in
both packages.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    Entity,
    EntityNotFound,
    InvalidReference,
    SearchCriteria,
    SearchResults,
    ValidationError,
    mint_token,
    paged,
    require,
    update_fields,
)


class AssetCategory:
    """Reference: ``AssetCategory`` enum (java-model)."""

    PERSON = "person"
    DEVICE = "device"
    HARDWARE = "hardware"

    ALL = (PERSON, DEVICE, HARDWARE)


#: the reference module the entities pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.services.assets"


@dataclasses.dataclass
class AssetType(Entity):
    """Reference: ``IAssetType`` — category + branding for a class of assets."""

    _PICKLE_AS = (_REF, "AssetType")

    name: str = ""
    description: str = ""
    category: str = AssetCategory.DEVICE
    image_url: str = ""
    icon: str = ""


@dataclasses.dataclass
class Asset(Entity):
    """Reference: ``IAsset`` — a concrete asset of some type."""

    _PICKLE_AS = (_REF, "Asset")

    name: str = ""
    asset_type: str = ""  # AssetType token
    image_url: str = ""


class AssetManagement:
    """The ``IAssetManagement`` SPI as an in-process host service.

    Dense asset ids are minted per tenant from the shared
    :class:`~sitewhere_tpu_torch.ids.IdentityMap` (``identity.asset`` space) — the
    same handles ``DeviceManagement`` writes into the registry's
    ``asset_id`` column, so enrichment output resolves back to these
    records.
    """

    def __init__(self, tenant: str, identity: IdentityMap):
        self.tenant = tenant
        self.identity = identity
        self._lock = threading.RLock()
        self._types: Dict[str, AssetType] = {}
        self._assets: Dict[str, Asset] = {}

    def _scoped(self, token: str) -> str:
        return f"{self.tenant}:{token}"

    # -- asset types -------------------------------------------------------

    def create_asset_type(self, token: Optional[str] = None, **fields) -> AssetType:
        with self._lock:
            token = token or mint_token("asset-type")
            require(token not in self._types, DuplicateToken(f"asset type {token!r} exists"))
            at = AssetType(token=token, **fields)
            require(bool(at.name), ValidationError("asset type name required"))
            require(
                at.category in AssetCategory.ALL,
                ValidationError(f"bad category {at.category!r}"),
            )
            self._types[token] = at
            return at

    def get_asset_type(self, token: str) -> AssetType:
        with self._lock:
            at = self._types.get(token)
            require(at is not None, EntityNotFound(f"no asset type {token!r}"))
            return at

    def update_asset_type(self, token: str, **fields) -> AssetType:
        with self._lock:
            at = self.get_asset_type(token)

            def validate(f):
                require(
                    f.get("category", at.category) in AssetCategory.ALL,
                    ValidationError(f"bad category {f.get('category')!r}"),
                )

            update_fields(
                at,
                fields,
                ("name", "description", "category", "image_url", "icon", "metadata"),
                validate,
            )
            return at

    def list_asset_types(
        self, criteria: Optional[SearchCriteria] = None
    ) -> SearchResults[AssetType]:
        with self._lock:
            return paged(sorted(self._types.values(), key=lambda t: t.token), criteria)

    def delete_asset_type(self, token: str) -> AssetType:
        with self._lock:
            at = self.get_asset_type(token)
            used = [a.token for a in self._assets.values() if a.asset_type == token]
            require(
                not used,
                InvalidReference(f"asset type {token!r} in use by assets {used[:3]}"),
            )
            del self._types[token]
            return at

    # -- assets ------------------------------------------------------------

    def create_asset(self, token: Optional[str] = None, **fields) -> Asset:
        with self._lock:
            token = token or mint_token("asset")
            require(token not in self._assets, DuplicateToken(f"asset {token!r} exists"))
            asset = Asset(token=token, **fields)
            require(bool(asset.name), ValidationError("asset name required"))
            require(
                asset.asset_type in self._types,
                InvalidReference(f"unknown asset type {asset.asset_type!r}"),
            )
            self._assets[token] = asset
            self.identity.asset.mint(self._scoped(token))
            return asset

    def get_asset(self, token: str) -> Asset:
        with self._lock:
            asset = self._assets.get(token)
            require(asset is not None, EntityNotFound(f"no asset {token!r}"))
            return asset

    def get_asset_by_id(self, asset_id: int) -> Asset:
        """Resolve a dense id from pipeline output back to the record."""
        scoped = self.identity.asset.token_of(asset_id)
        require(
            scoped is not None and scoped.startswith(self.tenant + ":"),
            EntityNotFound(f"no asset with id {asset_id}"),
        )
        return self.get_asset(scoped.split(":", 1)[1])

    def asset_dense_id(self, token: str) -> int:
        self.get_asset(token)
        return self.identity.asset.mint(self._scoped(token))

    def update_asset(self, token: str, **fields) -> Asset:
        with self._lock:
            asset = self.get_asset(token)

            def validate(f):
                if "asset_type" in f:
                    require(
                        f["asset_type"] in self._types,
                        InvalidReference(f"unknown asset type {f['asset_type']!r}"),
                    )

            update_fields(
                asset, fields, ("name", "asset_type", "image_url", "metadata"), validate
            )
            return asset

    def list_assets(
        self,
        criteria: Optional[SearchCriteria] = None,
        asset_type: Optional[str] = None,
    ) -> SearchResults[Asset]:
        with self._lock:
            matches = [
                a
                for a in self._assets.values()
                if asset_type is None or a.asset_type == asset_type
            ]
            return paged(sorted(matches, key=lambda a: a.token), criteria)

    def delete_asset(self, token: str) -> Asset:
        with self._lock:
            asset = self.get_asset(token)
            del self._assets[token]
            # The dense handle is NOT freed: registry rows and stored events
            # may still carry it, and a recycled handle would silently make
            # them resolve to an unrelated asset.  The tombstoned handle
            # resolves to EntityNotFound ("asset deleted"), and recreating
            # the same token reclaims the same handle.
            return asset
