"""Per-process runtime entry of the port."""

from tpucfn_torch.launch.launcher import (initialize_runtime, process_count,
                                          process_index)

__all__ = ["initialize_runtime", "process_count", "process_index"]
