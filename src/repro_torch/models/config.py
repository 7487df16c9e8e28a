"""Model configuration for the model zoo (PyTorch port).

A single ModelConfig covers every assigned architecture family:
dense GQA decoders, MoE, SSM (Mamba2), xLSTM (sLSTM/mLSTM), hybrid
(Mamba2 + shared attention), encoder-decoder (whisper) and VLM
(decoder-only LM consuming stubbed patch embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# Block kinds used in `block_pattern`.
ATTN = "attn"          # self-attention + MLP (standard decoder block)
MOE = "moe"            # self-attention + MoE FFN
MAMBA2 = "mamba2"      # Mamba2 SSD block
SLSTM = "slstm"        # xLSTM scalar-memory block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SHARED_ATTN = "shared_attn"  # zamba2-style shared transformer block (tied weights)

# Limits of the CUDA paged-attention kernels (csrc/paged_*_attention.cu): the
# prefill kernel holds a page tile and a query tile in one block's shared
# memory, which the two maxima keep under the H100's 227 KB per block; both
# kernels read K/V rows eight bytes (four bf16 values) at a time.
MAX_PAGE_SIZE = 64
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Config for the (stubbed-frontend) encoder of enc-dec / VLM models.

    The modality frontend itself (mel conv codec / ViT) is a stub:
    ``input_specs`` provides precomputed frame or patch embeddings with shape
    (batch, n_ctx, d_model_enc). The transformer encoder over those embeddings
    IS implemented (it is a normal transformer stack).
    """
    n_layers: int = 4
    d_model: int = 384
    n_heads: int = 6
    n_kv_heads: int = 6
    d_ff: int = 1536
    n_ctx: int = 1500           # number of frames / patches after the stub frontend


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    max_seq_len: int = 32768

    # attention options
    qk_norm: bool = False       # qwen3-style per-head q/k RMSNorm
    qkv_bias: bool = False      # qwen2-style bias on qkv projections
    sliding_window: int = 0     # 0 = full attention; >0 = SWA window
    rope_theta: float = 1e6
    use_rope: bool = True       # whisper uses learned positions instead
    attn_logit_softcap: float = 0.0

    # norm / activation
    norm_eps: float = 1e-6
    use_layernorm: bool = False  # whisper uses LayerNorm; others RMSNorm
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0           # expert hidden dim (if != d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # position-in-expert via argsort instead of the (A,E) one-hot cumsum
    # (beyond-paper §Perf optimization; see EXPERIMENTS.md)
    moe_sort_dispatch: bool = False
    # expert-parallel: shard the dispatch buffer + expert weights over the
    # `model` axis on the expert dim (all-to-all dispatch; §Perf)
    moe_ep: bool = False

    # SSM (Mamba2)
    ssm_state: int = 0          # state dim per head
    ssm_heads: int = 0          # number of SSM heads (0 -> derived)
    ssm_expand: int = 2
    ssm_chunk: int = 256        # chunked-scan block size
    ssm_conv: int = 4           # short conv width

    # xLSTM
    slstm_at: Tuple[int, ...] = ()   # layer indices that are sLSTM (rest mLSTM)

    # hybrid (zamba2): one shared attn block applied every `shared_attn_every`
    # mamba layers, with tied weights across applications.
    shared_attn_every: int = 0

    # encoder (whisper / vlm frontend stub)
    encoder: Optional[EncoderConfig] = None
    n_prefix_tokens: int = 0    # VLM: number of stub patch-embedding prefix tokens

    # numerics
    dtype: str = "bfloat16"     # activation/compute dtype
    param_dtype: str = "float32"
    # Paged KV pool storage dtype: "" follows `dtype` (status quo, bit-exact
    # paths), "int8"/"fp8" store quantized pages with a per-(page, kv-head)
    # f32 scale tensor alongside each pool — dequantized on read under a
    # documented tolerance contract (docs/serving.md).
    kv_dtype: str = ""

    # runtime switches
    # kept so configs compare field for field with the JAX package's; it
    # selects nothing here: a CUDA tensor always reads through the
    # hand-written kernels and a CPU tensor through their plain versions
    use_pallas: bool = False
    remat: bool = True          # rematerialize the layer scan in training
    act_shard: str = "batch"    # residual-stream sharding: batch|batch_seq|batch_model
    scan_layers: bool = True    # lax.scan over stacked layers (False = unroll)
    # cast f32 params to the compute dtype ONCE per step (outside remat),
    # instead of per-use inside every layer (§Perf: kills the repeated
    # f32<->bf16 weight conversions that remat re-executes)
    cast_params_once: bool = False

    # PICE: response-length prediction head (0 = disabled)
    length_buckets: int = 0

    # Paged-backend chunked prefill: ingest prompts in fixed chunks of this
    # many tokens, one chunk per engine step interleaved with the decode
    # batch (0 = monolithic prefill). Bounds decode head-of-line blocking by
    # one chunk and collapses prefill jit variants from log2(max_len)
    # bucket shapes to the single chunk shape.
    prefill_chunk: int = 0

    # citation for the config (paper / model card)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def resolved_kv_dtype(self) -> str:
        """Storage dtype of the paged KV pool ('' tracks the compute dtype)."""
        return self.kv_dtype if self.kv_dtype else self.dtype

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype in ("int8", "fp8")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def resolved_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        # mamba2 default: inner dim / 64-wide heads
        inner = self.ssm_expand * self.d_model
        return max(1, inner // 64)

    def block_pattern(self) -> Tuple[str, ...]:
        """The per-layer block kinds for this architecture."""
        if self.family == "ssm" and self.slstm_at:
            return tuple(
                SLSTM if i in set(self.slstm_at) else MLSTM
                for i in range(self.n_layers)
            )
        if self.family == "ssm":
            return tuple([MAMBA2] * self.n_layers)
        if self.family == "hybrid":
            assert self.shared_attn_every > 0
            pat = []
            for i in range(self.n_layers):
                pat.append(MAMBA2)
                if (i + 1) % self.shared_attn_every == 0:
                    pat.append(SHARED_ATTN)
            return tuple(pat)
        if self.is_moe:
            return tuple([MOE] * self.n_layers)
        return tuple([ATTN] * self.n_layers)

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA requires n_heads % n_kv_heads == 0"
        if self.is_moe:
            assert 0 < self.experts_per_token <= self.n_experts
        if self.family == "hybrid":
            assert self.shared_attn_every > 0
        if self.family in ("encdec",):
            assert self.encoder is not None

    def validate_paged(self, page_size: int, max_len: int) -> None:
        """Page and chunk contract of the paged KV backend.

        The CUDA paged-attention kernels need no sublane alignment: any
        positive page size and chunk length work. The prefill kernel stages
        one (page_size, head_dim) K/V page tile and a tile of query rows in
        shared memory, whose size `MAX_PAGE_SIZE` and `MAX_HEAD_DIM` bound;
        both kernels read K/V rows in 8-byte pieces, so head_dim is a
        multiple of `HEAD_DIM_MULTIPLE`, and of 8 for an int8 / fp8 pool.
        The kernel wrappers check the same limits on every call. The head_dim
        limits bind a stack with attention layers only: xlstm-1.3b's head_dim
        of 512 sizes its mLSTM states, which no attention kernel reads.
        """
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if max_len % page_size:
            raise ValueError("max_len must be page-aligned")
        if page_size > MAX_PAGE_SIZE:
            raise ValueError(f"page_size {page_size} exceeds the kernels' "
                             f"limit of {MAX_PAGE_SIZE}")
        attends = any(k in (ATTN, MOE, SHARED_ATTN)
                      for k in self.block_pattern())
        if attends and self.resolved_head_dim > MAX_HEAD_DIM:
            raise ValueError(f"head_dim {self.resolved_head_dim} exceeds the "
                             f"kernels' limit of {MAX_HEAD_DIM}")
        multiple = 8 if self.kv_quantized else HEAD_DIM_MULTIPLE
        if attends and self.resolved_head_dim % multiple:
            raise ValueError(f"head_dim {self.resolved_head_dim} is not a "
                             f"multiple of {multiple}")
        if self.kv_dtype not in ("", "float32", "bfloat16", "int8", "fp8"):
            raise ValueError(
                f"unsupported kv_dtype {self.kv_dtype!r}; expected one of "
                "'', 'float32', 'bfloat16', 'int8', 'fp8'")
        if self.prefill_chunk:
            if self.prefill_chunk < 0:
                raise ValueError("prefill_chunk must be positive")
            if self.prefill_chunk > max_len:
                raise ValueError(
                    "prefill_chunk larger than max_len never splits a prompt")

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 layers, d<=512)."""
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=512,
            name=self.name + "-reduced",
        )
        if self.is_moe:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["experts_per_token"] = min(self.experts_per_token, 2)
            kw["moe_d_ff"] = min(self.expert_d_ff, 256)
        if self.family == "ssm" and self.slstm_at:
            kw["slstm_at"] = (0,)
        if self.family == "hybrid":
            kw["shared_attn_every"] = 2
            kw["ssm_state"] = min(self.ssm_state or 16, 16)
        if self.family == "ssm" and not self.slstm_at:
            kw["ssm_state"] = min(self.ssm_state or 16, 16)
        if self.encoder is not None:
            kw["encoder"] = EncoderConfig(
                n_layers=2, d_model=kw["d_model"], n_heads=kw["n_heads"],
                n_kv_heads=kw["n_heads"], d_ff=kw["d_ff"], n_ctx=64)
        if self.n_prefix_tokens:
            kw["n_prefix_tokens"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 128
        kw.update(overrides)
        cfg = dataclasses.replace(self, **kw)
        cfg.validate()
        return cfg

    def with_(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # ------------------------------------------------------------------
    # Parameter accounting (used for roofline MODEL_FLOPS = 6*N*D).
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (active_only: MoE counts top-k experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d
        mlp_dense = 3 * d * self.d_ff if self.d_ff else 0
        total = 0
        pat = self.block_pattern()
        shared_counted = False
        for kind in pat:
            if kind == ATTN:
                total += attn + mlp_dense
            elif kind == MOE:
                n_e = self.experts_per_token if active_only else self.n_experts
                total += attn + 3 * d * self.expert_d_ff * n_e + d * self.n_experts
            elif kind == MAMBA2:
                inner = self.ssm_expand * d
                nh = self.resolved_ssm_heads
                total += d * (2 * inner + 2 * nh * self.ssm_state + nh) + inner * d
            elif kind in (SLSTM, MLSTM):
                inner = 2 * d
                total += 4 * d * inner + inner * d + 2 * d * (4 * d // 3)
            elif kind == SHARED_ATTN:
                if not shared_counted or not active_only:
                    # tied weights: count once for totals
                    if not shared_counted:
                        total += attn + mlp_dense
                        shared_counted = True
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            e = self.encoder
            e_attn = 4 * e.d_model * e.d_model
            total += e.n_layers * (e_attn + 2 * e.d_model * e.d_ff)
            # cross-attention in decoder layers
            total += self.n_layers * (2 * e.d_model * hd * n_kv + 2 * d * hd * n_q)
        return int(total)
