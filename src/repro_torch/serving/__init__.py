from repro_torch.serving.engine import (  # noqa: F401
    Completion, Request, ServingEngine)
from repro_torch.serving.recurrent import (  # noqa: F401
    RecurrentCompletion, RecurrentRequest, RecurrentServingEngine)
