"""Serving: the continuous-batching decode engine over a dense slot pool
or the paged KV block pool, with the prefix caches, chunked admission,
speculative decoding, fault handling, incremental delivery,
request-scoped observability, tenancy, KV transfer (DKV1) and the KV
spill tiers, and its streaming HTTP gateway with the stdlib client,
and the fleet above the gateways: the failure-tolerant prefix-affinity
router with its crash-safe write-ahead journal, the replica handles
and the SLO-driven fleet controller (port of
``deeplearning4j_tpu/serving``; its tensor-parallel engine is not
ported yet)."""

from deeplearning4j_tpu_torch.serving.client import (
    GatewayClient,
    GatewayError,
    GatewayStream,
)
from deeplearning4j_tpu_torch.serving.controller import FleetController
from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.faults import (
    FaultEvent,
    FaultPlan,
    ManualClock,
)
from deeplearning4j_tpu_torch.serving.gateway import (
    ROLES,
    STATUS_OF_REASON,
    ServingGateway,
)
from deeplearning4j_tpu_torch.serving.journal import (
    FSYNC_POLICIES,
    JournalError,
    WriteAheadJournal,
    read_records,
    recover_state,
)
from deeplearning4j_tpu_torch.serving.kv_tier import KVTierStore
from deeplearning4j_tpu_torch.serving.kv_transfer import (
    KVTransferError,
    KVTransferTooLarge,
    pack_prefix,
    unpack_prefix,
)
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PagedPrefixCache,
    RadixPrefixCache,
)
from deeplearning4j_tpu_torch.serving.replica_proc import (
    LocalReplica,
    ReplicaProcess,
)
from deeplearning4j_tpu_torch.serving.router import (
    REPLICA_STATES,
    RouterClient,
    ServingRouter,
)
from deeplearning4j_tpu_torch.serving.sampler import (
    greedy_acceptance,
    residual_sample,
    stochastic_acceptance,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
    Scheduler,
)
from deeplearning4j_tpu_torch.serving.spec import NgramDraftTable
from deeplearning4j_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    SYSTEM_TENANT,
    TenantRegistry,
    TenantSpec,
    TokenBucket,
    WeightedFairScheduler,
)
