from repro_torch.kernels.gru_cell.ops import (  # noqa: F401
    gru_decode, gru_decode_plain, gru_seq, gru_seq_plain)
