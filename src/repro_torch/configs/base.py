"""Model / system configuration dataclasses — a copy of
`repro.configs.base` (plain Python, field for field, defaults included).

Every assigned architecture is expressed as a ``ModelConfig``.
`repro_torch.models.model.build_model` is entirely config-driven: layer
*stages* are (pattern, repeats) pairs so heterogeneous stacks (gemma2
local/global, zamba2 mamba+shared-attention) run as one loop over a
repeated unit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

# Layer kind tags used in stage patterns.
ATTN = "attn"            # self-attention (global)
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MAMBA = "mamba"          # Mamba2 SSD block
SHARED_ATTN = "shared_attn"  # Zamba2-style shared-parameter attention block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- attention flavour ---
    window_size: int = 4096        # for ATTN_LOCAL layers
    logit_softcap: float = 0.0     # gemma2 final-logit softcap
    attn_softcap: float = 0.0      # gemma2 attention-score softcap
    qk_norm: bool = False          # qwen3 per-head RMSNorm on q/k
    rope_theta: float = 10000.0
    rope_mode: str = "standard"    # standard | mrope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)   # t/h/w freq dims (sum = head_dim//2)

    # --- MLA (MiniCPM3 / DeepSeek-style multi-head latent attention) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    dense_residual: bool = False   # arctic: dense FFN in parallel with the MoE FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- stack structure ---
    # stages: sequence of (pattern, repeats); pattern is a tuple of layer kinds.
    # Total layers == sum(len(p) * r). Empty -> (("attn",)*? derived) homogeneous.
    stages: Tuple[Tuple[Tuple[str, ...], int], ...] = ()

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- modality frontend stubs ---
    frontend: str = ""             # "" | "vision" | "audio"
    num_patches: int = 0           # VLM: patch-embedding positions prepended
    encoder_frames_ratio: int = 4  # audio: src frames = seq_len // ratio (train); see input_specs

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "float32"
    source: str = ""               # citation
    # JAX: lax.scan over layer stacks (True) vs fully unrolled (False). The
    # port loops over the repeats in Python either way; the field is kept so
    # that the configurations compare field for field.
    scan_layers: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if not self.stages:
            if self.family == "ssm":
                pattern: Tuple[str, ...] = (MAMBA,)
            else:
                pattern = (ATTN,)
            object.__setattr__(self, "stages", ((pattern, self.num_layers),))
        total = sum(len(p) * r for p, r in self.stages)
        assert total == self.num_layers, (
            f"{self.name}: stages cover {total} layers, config says {self.num_layers}")

    # -- derived ---------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        kinds = {k for p, _ in self.stages for k in p}
        return kinds <= {MAMBA}

    @property
    def sub_quadratic(self) -> bool:
        """True if every layer is SSM or sliding-window attention (long-context OK)."""
        kinds = {k for p, _ in self.stages for k in p}
        return ATTN not in kinds  # local-window attn + mamba + shared(windowed) ok
        # shared_attn layers are windowed in our hybrid implementation.

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (matches the built model; used for rooflines)."""
        d, hd = self.d_model, self.head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        emb = self.vocab_size * d
        unemb = 0 if self.tie_embeddings else self.vocab_size * d
        total = emb + unemb + d  # final norm

        def attn_params(shared_cost=True):
            if self.use_mla:
                rope_d = self.qk_rope_head_dim
                nope_d = self.qk_nope_head_dim
                p = d * self.q_lora_rank + self.q_lora_rank  # W_dq + norm
                p += self.q_lora_rank * self.num_heads * (nope_d + rope_d)
                p += d * (self.kv_lora_rank + rope_d) + self.kv_lora_rank
                p += self.kv_lora_rank * self.num_heads * (nope_d + self.v_head_dim)
                p += self.num_heads * self.v_head_dim * d
                return p
            p = d * (n_q + 2 * n_kv) + n_q * d
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params():
            return 3 * d * self.d_ff

        def moe_params():
            p = d * self.num_experts  # router
            p += self.num_experts * 3 * d * self.moe_d_ff
            if self.dense_residual:
                p += mlp_params()
            return p

        def mamba_params():
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            G = self.ssm_groups
            in_proj = d * (2 * di + 2 * G * N + H)
            conv = (di + 2 * G * N) * self.ssm_conv
            extras = 3 * H  # A_log, D, dt_bias
            out = di * d + di  # out_proj + gated norm
            return in_proj + conv + extras + out

        shared_attn_counted = False
        for pattern, repeats in self.stages:
            for kind in pattern:
                if kind in (ATTN, ATTN_LOCAL):
                    per = attn_params() + (moe_params() if self.is_moe else mlp_params()) + 2 * d
                    total += per * repeats
                elif kind == MAMBA:
                    total += (mamba_params() + d) * repeats
                elif kind == SHARED_ATTN:
                    if not shared_attn_counted:
                        total += attn_params() + mlp_params() + 2 * d
                        shared_attn_counted = True
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted via stages
            enc = (attn_params() + mlp_params() + 2 * d) * self.num_encoder_layers
            # decoder cross-attention per decoder layer
            cross = (d * (n_q + 2 * n_kv) + n_q * d + d) * self.num_layers
            total += enc + cross + d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        all_expert = self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        active_expert = self.num_layers * self.num_experts_per_tok * 3 * self.d_model * self.moe_d_ff
        return int(full - all_expert + active_expert)

    def reduced(self, *, layers: int = 2, d_model: int = 256, experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        hd = min(self.head_dim, 64)
        heads = max(2, min(4, self.num_heads))
        kv = 1 if self.num_kv_heads < self.num_heads else heads
        # preserve the stage *pattern* but shrink repeats to cover `layers`
        pattern = self.stages[0][0]
        plen = len(pattern)
        reps = max(1, layers // plen)
        nl = plen * reps
        kw: Dict[str, Any] = dict(
            name=self.name + "-reduced", num_layers=nl, d_model=d_model,
            num_heads=heads, num_kv_heads=kv, head_dim=hd,
            d_ff=2 * d_model, vocab_size=vocab,
            stages=((pattern, reps),),
            window_size=min(self.window_size, 64) if self.window_size else 0,
        )
        if self.is_moe:
            kw.update(num_experts=experts, num_experts_per_tok=min(2, self.num_experts_per_tok),
                      moe_d_ff=d_model)
        if self.use_mla:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32, ssm_chunk=32)
        if self.is_encoder_decoder:
            kw.update(num_encoder_layers=2)
        if self.frontend == "vision":
            kw.update(num_patches=16)
        if self.rope_mode == "mrope":
            half = hd // 2
            s1 = half // 4
            s2 = (half - s1) // 2
            kw.update(mrope_sections=(s1, s2, half - s1 - s2))
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class AFLConfig:
    """Asynchronous-FL (server-side) configuration — the paper's technique."""
    algorithm: str = "ace"         # ace | ace_direct | aced | fedbuff | ca2fl | asgd | delay_asgd
    n_clients: int = 16
    cache_dtype: str = "float32"   # float32 | bfloat16 | int8  (int8 = paper F.3.3)
    state_dtype: str = "float32"   # running-mean u / accumulators (bf16 at 100B+ scale)
    tau_algo: int = 10             # ACED delay threshold
    buffer_size: int = 10          # FedBuff / CA2FL M
    local_steps: int = 1           # K
    local_lr: float = 0.05
    server_lr: float = 0.1
    k_batch: int = 1               # arrivals consumed per server tick (the
    #                                event-batched scan engine); >1 sizes
    #                                ACED's cohort owner-ring (max_cohort)
    delay_beta: float = 5.0        # exponential mean delay
    delay_kappa: float = 0.0       # per-client speed skew (0 = homogeneous rates)
    max_delay_scale: float = 4.0   # delay-adaptive ASGD threshold multiplier
