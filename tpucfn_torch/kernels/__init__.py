"""Hand-written CUDA kernels for Hopper and their wrappers.

The names the JAX package's ``tpucfn.kernels`` exports, but for the
function ``flash_attention``: here that name stays the module
(``from tpucfn_torch.kernels import flash_attention as fa``), whose
function of the same name is ``fa.flash_attention``.
"""

from tpucfn_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_with_lse,
)
from tpucfn_torch.kernels.ring_attention import (  # noqa: F401
    make_ring_attention,
    ring_attention,
    ring_hops,
)
from tpucfn_torch.kernels.ulysses import make_ulysses_attention  # noqa: F401
from tpucfn_torch.kernels.auto import (  # noqa: F401
    auto_attention,
    auto_attention_static_zero,
    should_use_flash,
)
from tpucfn_torch.kernels import flash_autotune  # noqa: F401
