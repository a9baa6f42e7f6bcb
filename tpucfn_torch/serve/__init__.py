"""tpucfn_torch.serve — continuous-batching inference on the card.

* :mod:`tpucfn_torch.serve.kvcache` — paged KV-block accounting.
* :mod:`tpucfn_torch.serve.scheduler` — continuous batching.
* :mod:`tpucfn_torch.serve.engine` — prefill/decode/verify steps over a
  slot-resident cache, attention on the flash forward kernel.
* :mod:`tpucfn_torch.serve.frontend` — request queue, admission control,
  metrics.
* :mod:`tpucfn_torch.serve.router` — N replica Servers behind
  health-driven failover, deadline-budgeted retry, hedging and graceful
  drain.
* :mod:`tpucfn_torch.serve.spec` — speculative decoding: a draft engine
  at the same slot layout proposes, the target verifies k+1 positions a
  pass, and an acceptance-driven controller bounds the worst case.

CLI: ``python -m tpucfn_torch.cli serve``.
"""

from tpucfn_torch.serve.engine import ServeEngine  # noqa: F401
from tpucfn_torch.serve.frontend import (  # noqa: F401
    AdmissionError,
    Cancelled,
    DeadlineExceeded,
    ReplicaFailed,
    Requeued,
    Server,
    ServeRequest,
    ServingMetrics,
    SLOTracker,
)
from tpucfn_torch.serve.router import (  # noqa: F401
    CircuitBreaker,
    ReplicaRouter,
    RouterRequest,
)
from tpucfn_torch.serve.kvcache import (  # noqa: F401
    AdmitResult,
    BlockAllocator,
    BlockTable,
    KVCacheManager,
    OutOfBlocksError,
    PrefixMatch,
)
from tpucfn_torch.serve.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    DecodeWork,
    PrefillItem,
    PrefillWork,
    Sequence,
    prefill_bucket,
)
from tpucfn_torch.serve.spec import (  # noqa: F401
    SpecDecoder,
    SpecKController,
)
