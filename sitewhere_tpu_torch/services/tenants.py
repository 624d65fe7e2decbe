"""Tenant management + per-tenant engine manager.

Counterpart of ``sitewhere_tpu/services/tenants.py``, whole.

Reference: ``service-tenant-management`` (tenant CRUD over Mongo,
``templates/TenantTemplateManager.java`` + ``DatasetTemplateManager.java``
for bootstrap content, ``kafka/TenantModelProducer.java`` broadcasting
tenant-model updates) and the kernel's multitenant engine machinery
(``sitewhere-microservice/.../multitenant/MultitenantMicroservice.java:
242-260`` — one engine per tenant, independently restartable;
``MicroserviceTenantEngine.java`` building each engine from tenant config).

TPU-first reshape: a tenant engine is a *vertical slice of host services*
(identity map, registry mirror, device management…) sharing the one SPMD
pipeline — the tenant axis on device is just the ``tenant_id`` column
(SURVEY.md §2.4 "per-tenant engines" row), so engines are cheap: no
per-tenant Spring context, no per-tenant chips.  Tenant templates are
plain config overlays; dataset templates are Python initializers run
against the new engine (the Groovy-initializer analog).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import contextlib
import threading
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.device import DeviceLike
from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent, LifecycleState
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
from sitewhere_tpu_torch.services.assets import AssetManagement
from sitewhere_tpu_torch.services.device_management import DeviceManagement, RegistryMirror

logger = logging.getLogger("sitewhere_tpu_torch.tenants")

#: the reference module the records pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.services.tenants"


@dataclasses.dataclass
class Tenant(Entity):
    """Reference: ``ITenant`` (java-model) — name, auth token for device
    ingest, branding, authorized users, template choices."""

    _PICKLE_AS = (_REF, "Tenant")

    name: str = ""
    auth_token: str = ""
    logo_url: str = ""
    authorized_user_ids: List[str] = dataclasses.field(default_factory=list)
    tenant_template_id: str = "empty"
    dataset_template_id: str = "empty"


@dataclasses.dataclass(frozen=True)
class TenantTemplate:
    """Engine-configuration template (reference: tenant templates stored in
    Zk, listed by ``TenantTemplateManager``).  ``config`` overlays the
    engine defaults (capacities etc.)."""

    _PICKLE_AS = (_REF, "TenantTemplate")

    id: str
    name: str
    config: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DatasetTemplate:
    """Bootstrap-content template (reference: dataset templates running
    Groovy initializers, ``DatasetTemplateManager.java``).  ``initialize``
    receives the started :class:`TenantEngine`."""

    _PICKLE_AS = (_REF, "DatasetTemplate")

    id: str
    name: str
    initialize: Optional[Callable[["TenantEngine"], None]] = None


class TenantManagement:
    """The ``ITenantManagement`` SPI as an in-process host service.

    Mutation listeners are the ``tenant-model-updates`` Kafka topic analog:
    the engine manager subscribes and spins engines up/down.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._tenants: Dict[str, Tenant] = {}
        self._listeners: List[Callable[[str, Tenant], None]] = []
        self._templates: Dict[str, TenantTemplate] = {}
        self._datasets: Dict[str, DatasetTemplate] = {}
        self.add_tenant_template(TenantTemplate(id="empty", name="Empty"))
        self.add_dataset_template(DatasetTemplate(id="empty", name="Empty"))

    # -- templates ---------------------------------------------------------

    def add_tenant_template(self, template: TenantTemplate) -> None:
        self._templates[template.id] = template

    def add_dataset_template(self, template: DatasetTemplate) -> None:
        self._datasets[template.id] = template

    def list_tenant_templates(self) -> List[TenantTemplate]:
        return sorted(self._templates.values(), key=lambda t: t.id)

    def list_dataset_templates(self) -> List[DatasetTemplate]:
        return sorted(self._datasets.values(), key=lambda t: t.id)

    def get_tenant_template(self, template_id: str) -> TenantTemplate:
        t = self._templates.get(template_id)
        require(t is not None, EntityNotFound(f"no tenant template {template_id!r}"))
        return t

    def get_dataset_template(self, template_id: str) -> DatasetTemplate:
        t = self._datasets.get(template_id)
        require(t is not None, EntityNotFound(f"no dataset template {template_id!r}"))
        return t

    # -- listeners ---------------------------------------------------------

    def add_listener(self, listener: Callable[[str, Tenant], None]) -> None:
        self._listeners.append(listener)

    def _notify(self, kind: str, tenant: Tenant) -> None:
        for listener in list(self._listeners):
            try:
                listener(kind, tenant)
            except Exception:
                logger.exception("tenant listener failed for %s %s", kind, tenant.token)

    # -- CRUD --------------------------------------------------------------

    def create_tenant(self, token: Optional[str] = None, **fields) -> Tenant:
        with self._lock:
            token = token or mint_token("tenant")
            require(token not in self._tenants, DuplicateToken(f"tenant {token!r} exists"))
            tenant = Tenant(token=token, **fields)
            require(bool(tenant.name), ValidationError("tenant name required"))
            require(
                tenant.tenant_template_id in self._templates,
                InvalidReference(f"unknown tenant template {tenant.tenant_template_id!r}"),
            )
            require(
                tenant.dataset_template_id in self._datasets,
                InvalidReference(f"unknown dataset template {tenant.dataset_template_id!r}"),
            )
            if not tenant.auth_token:
                tenant.auth_token = mint_token("auth")
            self._tenants[token] = tenant
        self._notify("tenant.created", tenant)
        return tenant

    def get_tenant(self, token: str) -> Tenant:
        with self._lock:
            tenant = self._tenants.get(token)
            require(tenant is not None, EntityNotFound(f"no tenant {token!r}"))
            return tenant

    def get_tenant_by_auth_token(self, auth_token: str) -> Optional[Tenant]:
        """Reference: device ingest authenticates with the tenant auth token."""
        with self._lock:
            for tenant in self._tenants.values():
                if tenant.auth_token == auth_token:
                    return tenant
            return None

    def update_tenant(self, token: str, **fields) -> Tenant:
        with self._lock:
            tenant = self.get_tenant(token)
            update_fields(
                tenant,
                fields,
                ("name", "auth_token", "logo_url", "authorized_user_ids", "metadata"),
            )
        self._notify("tenant.updated", tenant)
        return tenant

    def delete_tenant(self, token: str) -> Tenant:
        with self._lock:
            tenant = self.get_tenant(token)
            del self._tenants[token]
        self._notify("tenant.deleted", tenant)
        return tenant

    def list_tenants(self, criteria: Optional[SearchCriteria] = None) -> SearchResults[Tenant]:
        with self._lock:
            return paged(sorted(self._tenants.values(), key=lambda t: t.token), criteria)

    def authorized_for(self, token: str, username: str) -> bool:
        tenant = self.get_tenant(token)
        return not tenant.authorized_user_ids or username in tenant.authorized_user_ids


ENGINE_DEFAULTS: Dict[str, object] = {
    "registry_capacity": 4096,
    "max_zones": 256,
    "max_verts": 32,
}


class TenantEngine(LifecycleComponent):
    """Per-tenant vertical slice of host services.

    Reference: ``MicroserviceTenantEngine`` — but where the reference builds
    a Spring child context per tenant per microservice, this engine is a
    handful of host objects; the heavy state (registry/zone tensors) is
    published into the shared pipeline with the tenant's dense id stamped
    on its rows.

    ``extras`` lets dataset/tenant templates attach additional components
    (command processors, connector managers…); lifecycle-managed children
    when they are :class:`LifecycleComponent`.
    """

    def __init__(self, tenant: Tenant, tenant_id: int, config: Dict[str, object],
                 identity: Optional[IdentityMap] = None,
                 mirror: Optional[RegistryMirror] = None,
                 device_management: Optional[DeviceManagement] = None,
                 asset_management: Optional[AssetManagement] = None,
                 device: DeviceLike = None):
        """Standalone by default; pass ``identity``/``mirror`` to run the
        engine over the INSTANCE's shared tensors (the TPU-first layout:
        one registry with a tenant column, per-tenant service façades —
        :class:`DeviceManagement` was built for this: global device
        tokens, tenant-scoped other namespaces, cross-tenant creation
        lock).  A standalone engine's own mirror publishes to ``device``
        (``None`` = the card)."""
        super().__init__(name=f"tenant-engine:{tenant.token}")
        self.tenant = tenant
        self.tenant_id = tenant_id  # dense id — the device-side tenant column value
        self.config = dict(ENGINE_DEFAULTS)
        self.config.update(config)
        cap = int(self.config["registry_capacity"])
        self.identity = identity or IdentityMap(capacity=cap)
        self.mirror = mirror or RegistryMirror(
            cap,
            max_zones=int(self.config["max_zones"]),
            max_verts=int(self.config["max_verts"]),
            device=device,
        )
        self.device_management = device_management or DeviceManagement(
            tenant.token, self.identity, self.mirror)
        self.asset_management = asset_management or AssetManagement(
            tenant.token, self.identity)
        self.extras: Dict[str, object] = {}

    def attach(self, name: str, component: object) -> object:
        self.extras[name] = component
        if isinstance(component, LifecycleComponent):
            self.add_child(component)
            if self.state == LifecycleState.STARTED:
                component.start()
        return component


class MultitenantEngineManager(LifecycleComponent):
    """Engine-per-tenant lifecycle manager.

    Reference: ``MultitenantMicroservice.initializeTenantEngines:242-260``
    (+ engine add/remove on tenant-model updates, independent restart
    ``:358-380``).  Subscribes to :class:`TenantManagement` mutations and
    keeps one started :class:`TenantEngine` per tenant.
    """

    def __init__(
        self,
        tenants: TenantManagement,
        engine_factory: Optional[Callable[[Tenant, int, Dict[str, object]], TenantEngine]] = None,
        tenant_ids: Optional[IdentityMap] = None,
        device: DeviceLike = None,
    ):
        super().__init__(name="tenant-engine-manager")
        self.tenants = tenants
        # the default factory builds standalone engines on ``device``
        self.engine_factory = engine_factory or functools.partial(
            TenantEngine, device=device)
        self._engines: Dict[str, TenantEngine] = {}
        # Dense tenant ids are global (they key the device-side tenant
        # column) and survive engine restarts.  The instance passes ITS
        # identity map so engine tenant ids match the pipeline's column.
        self._tenant_ids = tenant_ids or IdentityMap(capacity=1 << 16)
        self._lock = threading.RLock()
        # Per-token locks serialize restart vs delete for ONE tenant
        # without holding the global lock across a (slow) stop/start —
        # get_engine for other tenants must never block on a restart.
        # Entries are refcounted: evicted when the last holder releases,
        # so the map stays bounded under tenant churn and a waiter can
        # never be stranded on an evicted lock object.
        self._token_locks: Dict[str, list] = {}  # token → [Lock, refcount]
        tenants.add_listener(self._on_tenant_event)

    @contextlib.contextmanager
    def _token_guard(self, token: str):
        with self._lock:
            entry = self._token_locks.get(token)
            if entry is None:
                entry = self._token_locks[token] = [threading.Lock(), 0]
            entry[1] += 1
        entry[0].acquire()
        try:
            yield
        finally:
            entry[0].release()
            with self._lock:
                entry[1] -= 1
                if entry[1] == 0 \
                        and self._token_locks.get(token) is entry:
                    del self._token_locks[token]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        super().start()
        # page_size=0 = unpaged: every tenant's engine must come up, not
        # just the first default page
        for tenant in self.tenants.list_tenants(SearchCriteria(page_size=0)):
            self._ensure_engine(tenant)

    def stop(self) -> None:
        with self._lock:
            engines = list(self._engines.values())
        for engine in engines:
            if engine.state == LifecycleState.STARTED:
                engine.stop()
        super().stop()

    # -- engine registry ---------------------------------------------------

    def tenant_dense_id(self, token: str) -> int:
        return self._tenant_ids.tenant.mint(token)

    def get_engine(self, token: str) -> TenantEngine:
        with self._lock:
            engine = self._engines.get(token)
        require(engine is not None, EntityNotFound(f"no engine for tenant {token!r}"))
        return engine

    def list_engines(self) -> List[TenantEngine]:
        with self._lock:
            return list(self._engines.values())

    def restart_engine(self, token: str, rebuild: bool = False) -> TenantEngine:
        """Independent engine restart (reference: restartTenantEngine,
        ``MultitenantMicroservice.java:358-380``) — other tenants keep
        flowing.

        Default: stop→start the SAME engine (its host stores are the
        system of record and must survive; the reference reloads from
        Mongo, which we don't have per-engine).  ``rebuild=True`` tears
        the engine down and builds a fresh one through the factory —
        for engines whose factory rehydrates state externally."""
        # The per-token lock serializes restart against tenant.deleted (a
        # racing delete must not see its engine resurrected) WITHOUT
        # holding the global lock across a slow stop/start — other
        # tenants' get_engine/traffic keeps flowing during the restart.
        with self._token_guard(token):
            if not rebuild:
                with self._lock:
                    engine = self._engines.get(token)
                if engine is None:
                    # recovery lever for a tenant whose engine failed to
                    # start/bootstrap: retry from scratch
                    return self._ensure_engine(self.tenants.get_tenant(token))
                if engine.state == LifecycleState.STARTED:
                    engine.stop()
                engine.start()
                return engine
            with self._lock:
                old = self._engines.pop(token, None)
            if old is not None and old.state == LifecycleState.STARTED:
                old.stop()
            return self._ensure_engine(self.tenants.get_tenant(token))

    def _ensure_engine(self, tenant: Tenant) -> TenantEngine:
        # The whole ensure runs under the lock so a concurrent get_engine
        # never observes a half-started engine, and a failed start leaves
        # nothing registered (retryable on the next event/restart).
        with self._lock:
            engine = self._engines.get(tenant.token)
            if engine is not None:
                # Manager restart path: re-start engines parked by stop().
                if engine.state != LifecycleState.STARTED:
                    engine.start()
                return engine
            template = self.tenants.get_tenant_template(tenant.tenant_template_id)
            engine = self.engine_factory(
                tenant, self.tenant_dense_id(tenant.token), dict(template.config)
            )
            engine.start()
            dataset = self.tenants.get_dataset_template(tenant.dataset_template_id)
            if dataset.initialize is not None:
                # Bootstrap content exactly once (reference: dataset-bootstrapped
                # marker in Zk makes initialization idempotent).
                if not engine.tenant.metadata.get("dataset_bootstrapped"):
                    try:
                        dataset.initialize(engine)
                    except BaseException:
                        # A failed bootstrap must not leak a running engine
                        # nor register it — the tenant stays engine-less and
                        # a later _ensure_engine (event or manager restart)
                        # retries from scratch.
                        engine.stop()
                        raise
                    engine.tenant.metadata["dataset_bootstrapped"] = "true"
            self._engines[tenant.token] = engine
            return engine

    def _on_tenant_event(self, kind: str, tenant: Tenant) -> None:
        if self.state != LifecycleState.STARTED:
            return
        if kind == "tenant.created":
            self._ensure_engine(tenant)
        elif kind == "tenant.deleted":
            with self._token_guard(tenant.token):
                with self._lock:
                    engine = self._engines.pop(tenant.token, None)
                if engine is not None \
                        and engine.state == LifecycleState.STARTED:
                    engine.stop()
