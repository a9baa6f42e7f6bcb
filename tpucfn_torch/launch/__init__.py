"""The launcher and the per-process runtime entry of the port."""

from tpucfn_torch.launch.launcher import (Launcher, LocalTransport,
                                          SSHTransport, Transport,
                                          initialize_runtime,
                                          main_argv_for_script,
                                          process_count, process_index,
                                          run_with_restarts)

__all__ = ["Launcher", "LocalTransport", "SSHTransport", "Transport",
           "initialize_runtime", "main_argv_for_script", "process_count",
           "process_index", "run_with_restarts"]
