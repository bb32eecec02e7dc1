"""AdamW and gradient compression (the port of ``repro.optim``)."""
from repro_torch.optim.compression import (  # noqa: F401
    CompressionConfig, compress, compressed_bytes, init_error_state)
from repro_torch.optim.optimizer import (  # noqa: F401
    AdamWConfig, apply_updates, clip_by_global_norm, global_norm, init_state,
    lr_at)
