"""Model, input-shape and hardware configuration — the port of
``repro.configs.base``: ``ModelConfig`` and the input shapes
(``ShapeConfig``, ``SHAPES``, ``supports_shape``) as the reference has
them; the hardware model is the H100's (``H100``), where the reference
describes a TPU (its ``V5E`` is not ported).

Configs are frozen (hashable) so they can key plan caches and tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    family:
      dense   -- decoder-only transformer (GQA, optional SWA)
      moe     -- decoder-only transformer with MoE FFN (optional dense residual)
      ssm     -- recurrent blocks only (xLSTM: sLSTM + mLSTM)
      hybrid  -- recurrent + local-attention mix (RecurrentGemma; the
                 Mamba-2 + attention mix of granite-4.0-h, kind "mamba2")
      audio   -- transformer backbone over precomputed codec-frame embeddings
      vlm     -- transformer backbone with M-RoPE over precomputed patch embeds
      rnn     -- the paper's own LSTM stacks (SHARP benchmarks)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0  # arctic-style parallel dense residual branch
    capacity_factor: float = 1.25

    # --- attention ---
    window: int = 0  # sliding-window size; 0 = full causal attention
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits

    # --- recurrent / hybrid ---
    # cycle of per-layer block kinds; () means all 'attn'
    block_pattern: Tuple[str, ...] = ()
    rglru_width: int = 0  # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4  # temporal conv in recurrent blocks

    # --- Mamba-2 (block kind "mamba2"; arXiv:2405.21060) ---
    mamba_n_heads: int = 0
    mamba_d_head: int = 0
    mamba_d_state: int = 0
    mamba_n_groups: int = 1  # B and C shared by n_heads / n_groups heads
    mamba_d_conv: int = 4
    mamba_expand: int = 2  # d_inner = expand * d_model = n_heads * d_head
    mamba_chunk_size: int = 256  # the prefill's SSD chunk
    mamba_conv_bias: bool = True

    # --- residual-stream and head scalars (granite-4.0-h; 1 / 0 = off) ---
    embedding_multiplier: float = 1.0  # embeddings times this
    residual_multiplier: float = 1.0  # each block's output times this
    attention_multiplier: float = 0.0  # softmax scale; 0 -> 1 / sqrt(D)
    logits_scaling: float = 1.0  # logits divided by this
    position_embedding: str = "rope"  # rope | nope (no positional encoding)

    # --- paper RNN (LSTM) ---
    lstm_hidden: int = 0
    lstm_input: int = 0  # 0 -> lstm_hidden (paper assumes equal sizes)
    bidirectional: bool = False

    # --- behaviour ---
    scan_layers: bool = True
    remat_policy: str = "dots"  # none | dots | full
    remat_group: int = 1  # layers per remat unit (sqrt-L checkpointing);
    #                       >1 stores one residual per GROUP during training
    dtype: str = "bfloat16"
    embed_stub: bool = False  # audio/vlm: inputs are precomputed embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "rnn" and self.lstm_input == 0:
            object.__setattr__(self, "lstm_input", self.lstm_hidden)
        if self.family in ("ssm", "hybrid") and self.rglru_width == 0:
            object.__setattr__(self, "rglru_width", self.d_model)

    # -- layer pattern -------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, cycling ``block_pattern``."""
        if not self.block_pattern:
            return ("attn",) * self.n_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    # -- parameter counting (analytical; used for 6ND roofline) ---------
    def num_params(self, include_embed: bool = True) -> int:
        if self.family == "rnn":
            h, x = self.lstm_hidden, self.lstm_input
            per_dir = 4 * h * (x + h) + 8 * h
            per_layer = per_dir * (2 if self.bidirectional else 1)
            return per_layer * self.n_layers

        d = self.d_model
        total = 0
        for kind in self.layer_kinds():
            if kind == "attn":
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                total += self._ffn_params()
            elif kind == "rglru":
                w = self.rglru_width
                # in/out projections + gates (a, input gate) + conv
                total += d * w * 2 + w * d + 3 * w + self.conv1d_width * w
                total += self._ffn_params()
            elif kind == "mlstm":
                # up-proj x2 (gate+value), qkv projections at 2d, down-proj
                dh = 2 * d
                total += d * dh * 2 + 3 * dh * dh // 4 + dh * d
            elif kind == "slstm":
                dh = d
                total += 4 * dh * (d + dh) + 8 * dh + d * d
            elif kind == "mamba2":
                total += self._mamba2_params() + self._ffn_params()
            total += 2 * d  # norms
        if include_embed:
            total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def mamba_conv_dim(self) -> int:
        """Width of the conv's input xBC: x, then B and C of every group."""
        return self.mamba_d_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    def _mamba2_params(self) -> int:
        """in_proj (d -> z, xBC, dt), the depthwise conv (and its bias),
        A_log, D and dt_bias a head, the gated norm, out_proj."""
        d, di, c = self.d_model, self.mamba_d_inner, self.mamba_conv_dim
        H = self.mamba_n_heads
        conv = c * self.mamba_d_conv + (c if self.mamba_conv_bias else 0)
        return d * (di + c + H) + conv + 3 * H + di + di * d

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.n_experts:
            expert = 3 * d * self.d_ff  # gated MLP
            dense = 3 * d * self.moe_dense_ff if self.moe_dense_ff else 0
            router = d * self.n_experts
            return expert * self.n_experts + dense + router
        if self.d_ff == 0:
            return 0
        return 3 * d * self.d_ff  # gated (SwiGLU-style) MLP

    def num_active_params(self, include_embed: bool = False) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.num_params(include_embed=include_embed)
        full = self.num_params(include_embed=include_embed)
        expert_all = 3 * self.d_model * self.d_ff * self.n_experts
        expert_active = 3 * self.d_model * self.d_ff * self.experts_per_token
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "attn")
        # every attn layer carries the MoE FFN in our assemblies
        return full - (expert_all - expert_active) * n_moe_layers

    def model_flops_per_token(self) -> int:
        """Standard 6*N_active*D-style estimate (per token, fwd+bwd=6N, fwd=2N)."""
        return 2 * self.num_active_params(include_embed=False)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(model: ModelConfig, shape: ShapeConfig) -> bool:
    """Applicability per assignment: long_500k needs sub-quadratic attention."""
    if shape.name != "long_500k":
        return True
    if model.family in ("ssm",):
        return True
    kinds = set(model.layer_kinds())
    if "attn" in kinds and model.window == 0:
        return False  # pure full attention at 512k context: skip (documented)
    return True


# ---------------------------------------------------------------------------
# Hardware model: one NVIDIA H100 SXM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareConfig:
    """One card's peaks (NVIDIA's H100 SXM data sheet, dense, at its 700 W
    power limit).  ``nvlink_bw`` stands where the reference's TPU has its
    ICI link rate (read by no code, as that rate is not in the
    reference), and ``smem_bytes`` where it has VMEM: the shared memory
    one block may opt in to (227 KiB of an SM's 228), which the sequence
    kernels' plans read as ``kernels.common.SEQ_MAX_SMEM``.  The dry run
    reads ``hbm_bytes``; the cost bounds read the peaks."""

    name: str = "nvidia-h100-sxm"
    peak_flops_bf16: float = 989e12  # per card
    peak_flops_fp32: float = 67e12
    hbm_bw: float = 3.35e12  # bytes/s per card
    nvlink_bw: float = 450e9  # bytes/s per direction (NVLink 4, 18 links)
    hbm_bytes: int = 80 * 10**9
    smem_bytes: int = 232448  # csrc's kMaxSmem


H100 = HardwareConfig()
