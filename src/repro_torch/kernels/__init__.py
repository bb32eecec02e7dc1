"""Hand-written Hopper kernels of the port (``csrc/``) and their entry
points; ``kernels.lstm_cell`` carries ``lstm_seq`` and ``lstm_decode``."""
