"""Hand-written Hopper kernels of the port (``csrc/``) and their entry
points: ``kernels.lstm_cell`` carries ``lstm_seq``, ``lstm_decode`` and
``lstm_cell``; ``kernels.gru_cell`` carries ``gru_seq`` and
``gru_decode``; ``kernels.rglru`` carries ``rglru_scan`` and its
backward ``rglru_scan_bwd``;
``kernels.mvm_tile`` carries ``mvm`` and ``kernels.decode_attention``
``decode_attention``, the transformer decode step's two kernels;
``kernels.quant`` holds the int8 / bf16 / block-sparse weight transforms;
``kernels.build`` compiles and binds every kernel."""
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention, decode_attention_plain)
from repro_torch.kernels.gru_cell.ops import (  # noqa: F401
    gru_decode, gru_decode_plain, gru_seq, gru_seq_plain)
from repro_torch.kernels.lstm_cell.ops import (  # noqa: F401
    lstm_cell, lstm_cell_plain, lstm_decode, lstm_decode_plain, lstm_seq,
    lstm_seq_plain)
from repro_torch.kernels.mvm_tile.ops import mvm, mvm_plain  # noqa: F401
from repro_torch.kernels.rglru.ops import (  # noqa: F401
    rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain, rglru_scan_plain)
