from repro_torch.serving.recurrent import (  # noqa: F401
    RecurrentCompletion, RecurrentRequest, RecurrentServingEngine)
