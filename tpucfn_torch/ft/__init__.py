"""The fault-tolerance contract the port's training loop keeps."""

from tpucfn_torch.ft.policy import (CKPT_BLACKLIST_ENV, RESTORE_FAILED_RC,
                                    parse_ckpt_blacklist)

__all__ = ["CKPT_BLACKLIST_ENV", "RESTORE_FAILED_RC", "parse_ckpt_blacklist"]
