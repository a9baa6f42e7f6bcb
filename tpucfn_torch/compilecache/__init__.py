"""The fleet warm start of the port (the port of ``tpucfn/compilecache``).

* :mod:`~tpucfn_torch.compilecache.store` — the content-addressed local
  artifact store (copies of the JAX package's definitions; the default
  directory is the port's own);
* :mod:`~tpucfn_torch.compilecache.service` — the artifact server, its
  client and the local-store / fleet-fetch / single-flight-build
  orchestration (a verbatim copy);
* :mod:`~tpucfn_torch.compilecache.kernels` — the port's own half: what
  is cached is the kernel libraries ``nvcc`` builds, not XLA programs.

The first step's charge is split three ways as in the reference —
``compile``, ``compile_cached``, ``compile_fetched`` — through
:class:`tpucfn_torch.obs.profiler.CompileCacheProbe`.
"""

from tpucfn_torch.compilecache.service import (  # noqa: F401
    COMPILE_CACHE_ADDRS_ENV,
    COMPILE_CACHE_DIR_ENV,
    ArtifactClient,
    ArtifactServer,
    CompileCacheClient,
    cache_addrs_from_env,
)
from tpucfn_torch.compilecache.store import (  # noqa: F401
    ArtifactStore,
    CacheCorrupt,
    CacheMismatch,
    cache_key,
    default_store_dir,
)


def configure_from_env(*, tracer=None, registry=None, probe=None, env=None):
    """Build and install the process-default kernel-library cache from
    the launcher's env fan-out.  Returns it, or None when neither
    ``TPUCFN_COMPILE_CACHE_ADDRS`` nor ``TPUCFN_COMPILE_CACHE_DIR`` is set
    (then nothing is installed and the kernels build as they always
    did).  The identity comes from the card: only call this from
    processes that run the kernels."""
    from tpucfn_torch.compilecache.kernels import configure_from_env as _cfg

    return _cfg(tracer=tracer, registry=registry, probe=probe, env=env)
