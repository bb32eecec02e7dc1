from repro_torch.kernels.lstm_cell.ops import (  # noqa: F401
    lstm_cell, lstm_cell_plain, lstm_decode, lstm_decode_plain, lstm_seq,
    lstm_seq_plain)
