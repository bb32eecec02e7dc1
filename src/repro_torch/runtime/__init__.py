from repro_torch.runtime.errors import (  # noqa: F401
    FALLBACK_LEVELS, DeviceUnavailable, ExecutionReport, FaultInjector,
    LaunchError, NonFiniteStateError, PlanInvariantError, PlanRejected,
    QueueFull, RequestTimeout, ServingFault, not_ported)
from repro_torch.runtime.ft import (  # noqa: F401
    FTConfig, StragglerWatchdog, TrainLoop)
from repro_torch.runtime.obs import (  # noqa: F401
    NULL_TRACER, NullTracer, Span, Tracer, as_tracer, fence, measure_us,
    measure_samples, monotonic_s, slot_signature)
