"""The paper's own LSTM benchmark networks (Table 5) + DeepBench dims (Table 4).

A copy of ``repro.configs.sharp_lstm``: the port serves BYSDNE through
``serving.RecurrentServingEngine`` and runs EESEN through
``rnn.compile(...).forward``.
"""
from repro_torch.configs.base import ModelConfig

# Table 5 of the paper.
EESEN = ModelConfig(
    name="sharp-eesen", family="rnn", n_layers=5, d_model=340, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=0, lstm_hidden=340, bidirectional=True,
    scan_layers=False,
)
GMAT = ModelConfig(
    name="sharp-gmat", family="rnn", n_layers=17, d_model=1024, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=0, lstm_hidden=1024, scan_layers=False,
)
BYSDNE = ModelConfig(
    name="sharp-bysdne", family="rnn", n_layers=5, d_model=340, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=0, lstm_hidden=340, scan_layers=False,
)
RLDRADSPR = ModelConfig(
    name="sharp-rldradspr", family="rnn", n_layers=10, d_model=1024, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab_size=0, lstm_hidden=1024, scan_layers=False,
)

PAPER_NETWORKS = {
    "EESEN": (EESEN, 300),       # (model, representative time steps)
    "GMAT": (GMAT, 75),
    "BYSDNE": (BYSDNE, 30),
    "RLDRADSPR": (RLDRADSPR, 400),
}

# Table 4: DeepBench LSTM inference dims (hidden, time_steps).
DEEPBENCH = [(256, 150), (512, 25), (1024, 25), (1536, 50)]

# Fig. 9/10/11/12 sweep: hidden dims spanning the paper's application space
# (EESEN/BYSDNE are 340-dim; GMAT/RLDRADSPR 1024; DeepBench adds 1536 — a mix
# of padding-hostile and padding-friendly sizes, which is the point of Fig 10).
SWEEP_HIDDEN_DIMS = [100, 256, 340, 512, 1000, 1024, 1536, 2048]
MAC_BUDGETS = [1024, 4096, 16384, 65536]  # 1K, 4K, 16K, 64K
K_WIDTHS = [32, 64, 128, 256, 512]


def lstm_config(hidden: int, layers: int = 1) -> ModelConfig:
    return ModelConfig(
        name=f"sharp-lstm-{hidden}", family="rnn", n_layers=layers,
        n_heads=1, n_kv_heads=1, d_model=hidden, d_ff=0, vocab_size=0,
        lstm_hidden=hidden, scan_layers=False,
    )


def config() -> ModelConfig:
    """Default paper model for the quickstart (GMAT-like single layer)."""
    return lstm_config(1024, layers=1)


def eesen_demo(dtype: str = "float32") -> ModelConfig:
    """The paper's bidirectional EESEN stack (Table 5) in a demo-friendly
    dtype, compiled end-to-end through the dispatcher's interleaved
    bidirectional wavefront (`rnn.compile`)."""
    import dataclasses

    return dataclasses.replace(EESEN, dtype=dtype)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="sharp-lstm-reduced", family="rnn", n_layers=2, n_heads=1,
        n_kv_heads=1, d_model=48, d_ff=0, vocab_size=0, lstm_hidden=48,
        scan_layers=False, dtype="float32",
    )
