"""repro_torch.rnn — the unified recurrent-stack front-end (the port of
``repro.rnn``).

    from repro_torch import rnn

    cs = rnn.compile(stack_params, rnn.ExecutionPolicy(), device="cuda")
    ys = cs.forward(xs)                  # (B, T, H)
    ys, state = cs.prefill(xs)           # + exact t=T (h, c)
    y_t, state = cs.decode(x_t, state)   # one chained launch per tick
    print(cs.plan.describe(), cs.stats)
"""
from repro_torch.rnn.compiled import (CompiledStack, StackStats,  # noqa: F401
                                      compile, resolve_device)
from repro_torch.rnn.policy import (COST_MODELS, DTYPES,  # noqa: F401
                                    ON_FAULT, SCHEDULES, VERIFY,
                                    ExecutionPolicy)
from repro_torch.runtime.errors import (FALLBACK_LEVELS,  # noqa: F401
                                        FaultInjector, LaunchError,
                                        NonFiniteStateError,
                                        PlanInvariantError, PlanRejected,
                                        QueueFull, RequestTimeout,
                                        ServingFault)

__all__ = ["compile", "CompiledStack", "StackStats", "ExecutionPolicy",
           "resolve_device", "SCHEDULES", "DTYPES", "ON_FAULT", "VERIFY",
           "COST_MODELS", "FALLBACK_LEVELS",
           "ServingFault", "LaunchError", "NonFiniteStateError",
           "PlanRejected", "PlanInvariantError", "QueueFull",
           "RequestTimeout", "FaultInjector"]
