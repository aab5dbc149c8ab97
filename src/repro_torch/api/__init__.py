"""Declarative control plane: typed API store + reconciler controllers.

The API-centric architecture the paper argues for (§II–§III): scenarios
submit versioned objects (ResourceClaims, Workloads) to an
:class:`ApiStore` and wait on ``Ready`` conditions; the
:class:`ControlPlane`'s reconcilers do all the wiring that launch
scripts used to hand-sequence. See docs/API.md for the workflow.

The port's own copy of the JAX package's ``api/__init__.py`` (pure
Python; the port imports nothing of that package).
"""

from .objects import (ApiObject, CanaryRollout, Condition, DisruptionBudget,
                      Lease, Node, ObjectMeta,
                      ObjectStatus, Workload, TRUE, FALSE, UNKNOWN,
                      CONDITION_ALLOCATED, CONDITION_ATTACHED,
                      CONDITION_PREPARED, CONDITION_READY,
                      CONDITION_SCHEDULED, PHASE_ORDER)
from .store import (AdmissionError, ApiError, ApiStore, ConflictError, Watch,
                    WatchEvent, KIND_OF)
from .controllers import (AllocationController, AttachmentController,
                          ControlPlane, Controller, PrepareController,
                          WorkloadController, RETRYABLE_REASONS)
from .persistence import (RecoveryError, RecoveryInfo, StoreJournal,
                          WriteAheadLog, allocation_fingerprint,
                          allocation_records, dump_store, has_state,
                          load_store, recover_store, store_dump_json,
                          store_fingerprint)
from .workqueue import WorkQueue
from .chaos import FaultInjector, InjectedFault, sync_point
from .runtime import (ConditionWaiter, ControlPlaneRuntime, RuntimeStats,
                      TokenBucket)

__all__ = [
    "ApiObject", "CanaryRollout", "Condition", "DisruptionBudget", "Lease",
    "Node", "ObjectMeta", "ObjectStatus",
    "Workload", "TRUE", "FALSE", "UNKNOWN",
    "CONDITION_ALLOCATED", "CONDITION_PREPARED", "CONDITION_ATTACHED",
    "CONDITION_READY", "CONDITION_SCHEDULED", "PHASE_ORDER",
    "AdmissionError", "ApiError", "ApiStore", "ConflictError", "Watch",
    "WatchEvent", "KIND_OF",
    "Controller", "AllocationController", "PrepareController",
    "AttachmentController", "WorkloadController", "ControlPlane",
    "WorkQueue", "RETRYABLE_REASONS",
    "RecoveryError", "RecoveryInfo", "StoreJournal", "WriteAheadLog",
    "allocation_fingerprint", "allocation_records", "dump_store",
    "has_state", "load_store", "recover_store", "store_dump_json",
    "store_fingerprint",
    "FaultInjector", "InjectedFault", "sync_point",
    "ConditionWaiter", "ControlPlaneRuntime", "RuntimeStats", "TokenBucket",
]
