"""The fault-tolerance plane (copies of the JAX package's ``tpucfn/ft/``):
heartbeat failure detection (``heartbeat``), recovery policies with
budgets and backoff (``policy``), the gang coordinator that runs them
over the launcher's process table (``coordinator``), its write-ahead
journal (``journal``), the deterministic chaos harness (``chaos``), and
preemption notices with the drain protocol (``preempt``)."""

from tpucfn_torch.ft.chaos import (ChaosEngine, ChaosEvent, ChaosSpec,
                                   ChaosTarget, ControlPlaneChaosTarget,
                                   corrupt_latest_checkpoint)
from tpucfn_torch.ft.coordinator import GangCoordinator
from tpucfn_torch.ft.heartbeat import (FleetView, HeartbeatMonitor,
                                       HeartbeatWriter, HostState,
                                       HostVerdict, MonitorConfig,
                                       heartbeat_path, read_heartbeats)
from tpucfn_torch.ft.journal import (JOURNAL_KINDS, AdoptedProcess,
                                     CoordinatorState, JournalError,
                                     JournalWriter, crash_point,
                                     journal_path, replay_journal)
from tpucfn_torch.ft.policy import (CKPT_BLACKLIST_ENV, RESTORE_FAILED_RC,
                                    Action, Decision, Failure, FailureKind,
                                    GangRestart, RecoveryPolicy,
                                    RestartBudget, SoloRestart,
                                    StragglerGuard, format_ckpt_blacklist,
                                    parse_ckpt_blacklist, policy_from_name)
from tpucfn_torch.ft.preempt import (PreemptNotice, consume_notice,
                                     drain_requested, request_drain,
                                     write_notice)

__all__ = ["JOURNAL_KINDS", "CKPT_BLACKLIST_ENV", "RESTORE_FAILED_RC",
           "Action", "AdoptedProcess", "ChaosEngine", "ChaosEvent",
           "ChaosSpec", "ChaosTarget", "ControlPlaneChaosTarget",
           "CoordinatorState", "Decision", "Failure", "FailureKind",
           "FleetView", "GangCoordinator", "GangRestart", "HeartbeatMonitor",
           "HeartbeatWriter", "HostState", "HostVerdict", "JournalError",
           "JournalWriter", "MonitorConfig", "PreemptNotice",
           "RecoveryPolicy", "RestartBudget", "SoloRestart",
           "StragglerGuard", "consume_notice", "corrupt_latest_checkpoint",
           "crash_point", "drain_requested", "format_ckpt_blacklist",
           "heartbeat_path", "journal_path", "parse_ckpt_blacklist",
           "policy_from_name", "read_heartbeats", "replay_journal",
           "request_drain", "write_notice"]
