from quantizedattention_tpu.utils.testing import mismatch_report, MismatchReport
from quantizedattention_tpu.utils.runtime import (
    use_interpret_mode,
    enable_compile_cache,
    cdiv,
    round_up,
)
from quantizedattention_tpu.utils.profiling import (
    DEVICE_PEAKS,
    KernelTiming,
    attention_flops,
    device_peaks,
    time_attention,
    time_seconds,
)
from quantizedattention_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
from quantizedattention_tpu.utils.failure import (
    FailureEvent,
    StepGuard,
    Watchdog,
    device_heartbeat,
    hosts_alive,
)

__all__ = [
    "mismatch_report",
    "MismatchReport",
    "use_interpret_mode",
    "enable_compile_cache",
    "cdiv",
    "round_up",
    "DEVICE_PEAKS",
    "KernelTiming",
    "attention_flops",
    "device_peaks",
    "time_attention",
    "time_seconds",
    "save_checkpoint",
    "load_checkpoint",
    "FailureEvent",
    "StepGuard",
    "Watchdog",
    "device_heartbeat",
    "hosts_alive",
]
