"""tpucfn_torch.serve — continuous-batching inference on the card.

* :mod:`tpucfn_torch.serve.kvcache` — paged KV-block accounting.
* :mod:`tpucfn_torch.serve.scheduler` — continuous batching.
* :mod:`tpucfn_torch.serve.engine` — prefill/decode steps over a
  slot-resident cache, attention on the flash forward kernel.
* :mod:`tpucfn_torch.serve.frontend` — request queue, admission control,
  metrics.

CLI: ``python -m tpucfn_torch.cli serve``.
"""

from tpucfn_torch.serve.engine import ServeEngine  # noqa: F401
from tpucfn_torch.serve.frontend import (  # noqa: F401
    AdmissionError,
    DeadlineExceeded,
    Server,
    ServeRequest,
    ServingMetrics,
)
