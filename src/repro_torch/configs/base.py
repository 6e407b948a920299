"""Architecture and input-shape configs of the LLM stack, and their registry.

The port's own copy of the reference's ``repro/configs/base.py``
(``ArchConfig``, ``InputShape``, ``TrainConfig``, ``smoke_variant``, the
analytic parameter count), so that the port imports nothing of
``repro``. Every architecture lives in its own module (``configs/<id>.py``) exporting
``CONFIG``. ``get_config`` resolves the families whose serving path the
port runs (dense, moe, vlm, hybrid, ssm); the audio family raises
``NotImplementedError`` naming the ROADMAP step that ports it.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture, parameterized enough to cover
    dense / MoE / SSM / hybrid / enc-dec / VLM members of the zoo."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation bracket from the assignment

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # qwen3
    rope_theta: float = 10_000.0
    rope_partial: float = 1.0        # fraction of head_dim rotated (chatglm 0.5)
    sliding_window: int = 0          # 0 = full causal; >0 = SWA (mixtral 4096)
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0               # mamba2 state size per head
    ssm_head_dim: int = 64           # mamba2 P (channels per head)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv_width: int = 4
    wkv_head_dim: int = 64           # rwkv6 head size

    # --- hybrid (zamba2): shared attention block every N ssm layers ---------
    shared_attn_period: int = 0      # 0 = no shared attention blocks

    # --- enc-dec (whisper) ---------------------------------------------------
    n_encoder_layers: int = 0        # >0 => encoder-decoder
    n_audio_frames: int = 1500       # stub conv frontend output length

    # --- vlm ------------------------------------------------------------------
    n_image_tokens: int = 0          # stub ViT frontend output length

    # --- norm / misc ----------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards
        evenly over the model axis (logical vocab padding; padded logits are
        masked to -inf in unembed)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads, f"{self.name}: no heads and no head_dim"
        return self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim if (self.n_heads or self.head_dim) else 0
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd

        def attn_params():
            return d * n_q + 2 * d * n_kv + n_q * d

        def mlp_params():
            return 3 * d * f  # SwiGLU: gate, up, down

        def moe_params():
            return self.n_experts * 3 * d * f + d * self.n_experts

        def mamba2_params():
            d_in = self.ssm_expand * d
            n = self.ssm_state
            nheads = d_in // self.ssm_head_dim
            zxbcdt = d * (2 * d_in + 2 * n + nheads)
            conv = self.ssm_conv_width * (d_in + 2 * n)
            return zxbcdt + conv + nheads * 2 + d_in * d + d_in

        def rwkv6_params():
            # r,k,v,g,w projections + output + time-mix lora + ffn(2 mats)
            att = 5 * d * d + d * d + 6 * d * 96
            ffn = d * int(3.5 * d) * 2 if not f else (d * f + f * d)
            return att + ffn

        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        if self.family == "ssm":  # rwkv6
            total += self.n_layers * rwkv6_params()
        elif self.family == "hybrid":
            total += self.n_layers * mamba2_params()
            if self.shared_attn_period:
                total += attn_params() + mlp_params()  # one shared block
        elif self.is_moe:
            total += self.n_layers * (attn_params() + moe_params())
        elif self.is_encdec:
            total += self.n_encoder_layers * (attn_params() + 2 * d * f)
            total += self.n_layers * (2 * attn_params() + 2 * d * f)
        else:
            total += self.n_layers * (attn_params() + mlp_params())
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * self.n_experts * 3 * d * f
        return dense_like + self.n_layers * self.experts_per_token * 3 * d * f

    # ------------------------------------------------------------------
    def smoke_variant(self) -> "ArchConfig":
        """Reduced config of the same family: 2 layers, d_model<=512,
        <=4 experts — used by CPU smoke tests."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(4, self.n_heads)) if self.n_heads else 0
        n_kv = max(1, min(n_heads, self.n_kv_heads)) if self.n_kv_heads else 0
        updates = dict(
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
        )
        if self.is_moe:
            updates.update(n_experts=4, experts_per_token=min(2, self.experts_per_token))
        if self.family in ("ssm", "hybrid"):
            updates.update(ssm_state=min(self.ssm_state or 16, 16),
                           ssm_head_dim=32, wkv_head_dim=32)
        if self.shared_attn_period:
            updates.update(shared_attn_period=1)
        if self.is_encdec:
            updates.update(n_encoder_layers=2, n_audio_frames=16)
        if self.n_image_tokens:
            updates.update(n_image_tokens=8)
        if self.sliding_window:
            updates.update(sliding_window=64)
        return replace(self, **updates)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters of LLM training (``launch/train.py``)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    seed: int = 0
    remat: bool = True                # activation checkpointing per layer
    remat_policy: str = "full"        # full | dots (save matmul outputs)
    microbatches: int = 1             # grad-accumulation steps per update


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "qwen3_4b",
    "minitron_8b",
    "zamba2_7b",
    "rwkv6_7b",
    "chatglm3_6b",
    "granite_moe_1b_a400m",
    "llama3_8b",
    "whisper_medium",
    "mixtral_8x7b",
    "internvl2_1b",
)

DENSE_IDS = ("qwen3_4b", "llama3_8b", "minitron_8b", "chatglm3_6b")
MOE_IDS = ("granite_moe_1b_a400m", "mixtral_8x7b")
VLM_IDS = ("internvl2_1b",)
RECURRENT_IDS = ("zamba2_7b", "rwkv6_7b")

# the families the port runs
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")
# the families whose layers are all attention + an MLP; they also train,
# since their attention has a backward (L2)
ATTENTION_FAMILIES = ("dense", "moe", "vlm")

# the ROADMAP step (section A) that ports each family not ported yet
NOT_PORTED = {
    "whisper_medium": "audio family (layernorm, cross-attention), "
                      "ROADMAP A.20",
}

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: {NOT_PORTED[arch_id]}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG

