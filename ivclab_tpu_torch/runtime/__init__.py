"""Container format, the native-code loader, tracing, checks and recovery."""

from ivclab_tpu_torch.runtime import native
from ivclab_tpu_torch.runtime.debug import assert_finite, assert_in_range, checked, debug_mode
from ivclab_tpu_torch.runtime.elastic import (
    DistributedHeartbeat,
    HeartbeatMonitor,
    reencode_missing_gops,
)
from ivclab_tpu_torch.runtime.trace import StageTimer, device_trace

__all__ = [
    "native",
    "StageTimer", "device_trace",
    "checked", "assert_finite", "assert_in_range", "debug_mode",
    "HeartbeatMonitor", "DistributedHeartbeat", "reencode_missing_gops",
]
