"""Config system: one frozen dataclass per concern, composable, hashable.

ModelConfig covers every assigned architecture family (dense / moe / hybrid /
ssm / vlm / audio enc-dec); TrainConfig and ServeConfig parameterize the
drivers; MeshConfig the distribution. Arch files in this package export
`CONFIG` (the exact published config) and `smoke_config()` (a reduced
same-family variant for CPU tests).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # -- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    attn_impl: str = "auto"          # ref | flash | auto
    attn_logit_softcap: float = 0.0

    # -- MLA (deepseek-v2) --------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # -- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    d_inner: int = 0                 # 0 -> 2 * d_model
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0              # zamba2: shared attn block every k layers
    slstm_every: int = 0             # xlstm: one sLSTM per k-block super-block
    mlstm_proj_factor: float = 2.0

    # -- encoder-decoder ------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    cross_attn: bool = False
    src_frontend: str = ""           # 'audio_frames' | 'vit_patches' | ''
    frontend_dim: int = 0            # stub embedding dim fed by input_specs
    n_patches: int = 0               # vlm: patches prepended to the text seq

    # -- numerics / structure -------------------------------------------------
    #: cast block-output cotangents to bf16 before they reach the TP dx
    #: all-reduces (halves backward activation-gradient wire bytes)
    bf16_grad_reduce: bool = False
    #: manual Megatron TP for the MLP (parallel/tp.py): ONE bf16 psum fwd +
    #: ONE bf16 psum bwd per block instead of GSPMD's per-projection f32 ARs
    manual_tp: bool = False
    #: models too small to tensor-parallel (heads < TP, params fit
    #: replicated): train with the model axis folded into data parallelism
    #: (EXPERIMENTS.md §Perf internvl2: roofline fraction 0.005 -> 0.36)
    prefer_dp_only: bool = False
    mlp_gated: bool = True           # SwiGLU (3 mats) vs GELU MLP (2 mats)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "dots_saveable"     # none | dots_saveable | full
    scan_layers: bool = True

    # -- derived ----------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
        if self.family in ("dense", "moe", "vlm"):
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.moe:
            assert self.n_experts > 0 and self.top_k > 0
        if self.family == "audio":
            assert self.enc_layers and self.dec_layers and self.cross_attn
        if self.attn_every:
            assert self.n_layers % self.attn_every == 0
        if self.slstm_every:
            assert self.n_layers % self.slstm_every == 0
        return self

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, v, h = self.d_model, self.vocab, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":   # xlstm
            total = (self.n_layers - self.n_slstm) * _mlstm_block_params(self) \
                + self.n_slstm * _slstm_block_params(self)
            return total + emb
        if self.family == "hybrid":
            mamba = self.n_layers * _mamba_block_params(self)
            n_attn = self.n_layers // self.attn_every if self.attn_every else 0
            attn = _attn_params(self)  # weight-tied: ONE copy
            return mamba + attn + emb
        if self.family == "audio":
            enc = self.enc_layers * (_attn_params(self) + _mlp_params(self, self.d_ff))
            dec = self.dec_layers * (2 * _attn_params(self) + _mlp_params(self, self.d_ff))
            return enc + dec + emb
        per_layer = _attn_params(self) + _mlp_or_moe_params(self)
        return self.n_layers * per_layer + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        dense_mlp = _mlp_params(self, self.d_ff) if self.d_ff else 0
        act_moe = (self.top_k + self.n_shared_experts) * _mlp_params(self, self.moe_d_ff)
        per_layer_active = _attn_params(self) + act_moe
        dense_layers = self.first_dense_layers
        moe_layers = self.n_layers - dense_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return (moe_layers * per_layer_active
                + dense_layers * (_attn_params(self) + dense_mlp) + emb)

    @property
    def n_slstm(self) -> int:
        if not self.slstm_every:
            return 0
        return self.n_layers // self.slstm_every


def _attn_params(cfg: ModelConfig) -> int:
    d, h = cfg.d_model, cfg.head_dim_
    if cfg.mla:
        q = d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        kv_a = d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        kv_b = cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        o = cfg.n_heads * cfg.v_head_dim * d
        return q + kv_a + kv_b + o
    q = d * cfg.n_heads * h
    kv = 2 * d * cfg.n_kv_heads * h
    o = cfg.n_heads * h * d
    return q + kv + o


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    # SwiGLU: gate+up+down (3 mats); GELU MLP: up+down (2 mats)
    return (3 if cfg.mlp_gated else 2) * cfg.d_model * d_ff


def _mlp_or_moe_params(cfg: ModelConfig) -> int:
    if not cfg.moe:
        return _mlp_params(cfg, cfg.d_ff)
    routed = cfg.n_experts * _mlp_params(cfg, cfg.moe_d_ff)
    shared = cfg.n_shared_experts * _mlp_params(cfg, cfg.moe_d_ff)
    router = cfg.d_model * cfg.n_experts
    dense_frac = cfg.first_dense_layers / cfg.n_layers
    dense = _mlp_params(cfg, cfg.d_ff) if cfg.d_ff else 0
    # average per layer (first_dense_layers use the dense MLP)
    return int(dense_frac * dense + (1 - dense_frac) * (routed + shared + router))


def _mamba_block_params(cfg: ModelConfig) -> int:
    d, di, n = cfg.d_model, cfg.d_inner_, cfg.ssm_state
    heads = cfg.n_ssm_heads
    in_proj = d * (2 * di + 2 * n + heads)  # x, z, B, C, dt
    conv = 4 * (di + 2 * n)
    out = di * d
    return in_proj + conv + out + 2 * heads  # + A, D per head


def _mlstm_block_params(cfg: ModelConfig) -> int:
    # matches models/xlstm.py: up d->2di, block-diag qkv (per head), scalar
    # gates d->2H, down di->d, norm scales
    d = cfg.d_model
    di = int(d * cfg.mlstm_proj_factor)
    h = max(cfg.n_heads, 1)
    up = d * 2 * di
    qkv = 3 * di * (di // h)  # block-diagonal per head
    gates = d * 2 * h
    down = di * d
    return up + qkv + gates + down + d + di


def _slstm_block_params(cfg: ModelConfig) -> int:
    # matches models/xlstm.py: 4 input gates d->d, block-diag recurrent 4
    # gates, gated FFN with factor 4/3
    d = cfg.d_model
    h = max(cfg.n_heads, 1)
    inp = 4 * d * d
    rec = 4 * d * (d // h)
    ffn = 3 * d * int(d * 4 / 3)
    return inp + rec + ffn + 2 * d


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axes, self.shape)).get(name, 1)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode | long_decode

    @property
    def is_serving(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    zero1: bool = True               # shard optimizer state over data axis
    grad_compression: str = "none"   # none | int8
    #: accumulate microbatch grads inside ONE value_and_grad-over-scan so the
    #: data-axis gradient all-reduce happens ONCE per step instead of once
    #: per microbatch (pjit emits the psum inside the scan body otherwise)
    deferred_grad_reduce: bool = False
    microbatches: int = 1            # gradient accumulation / pipeline chunks
    ckpt_interval: int = 200
    ckpt_async: bool = True
    seed: int = 0
    #: host-tracer overhead budget as a fraction of wall time (0 = governor
    #: off, every boundary timed on every call).  When > 0 the trainer
    #: attaches the adaptive governor (core.sampler): hot edges back off to
    #: 1-in-k timing with unbiased scale-up while counting stays exact.
    xfa_overhead_budget: float = 0.0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 2_048
    #: prefill proceeds in chunks of at most this many prompt tokens per
    #: forward_chunk step: the admission chunk AND every continuation
    #: chunk of a longer prompt's tail (true in-model chunked prefill —
    #: each chunk lands at the slot's cache offset in one positioned
    #: forward; admission cost is O(chunk), never O(prompt))
    prefill_chunk: int = 512
    #: continuation chunks of the prompt tail use this width (0 = same as
    #: prefill_chunk).  tail_chunk=1 reproduces the legacy
    #: one-token-per-tick tail feed through the SAME unified code path —
    #: benchmarks/serve.py uses it as the TTFT comparison baseline
    tail_chunk: int = 0
    #: round every prefill-chunk width up to the next power-of-two bucket
    #: (pad masked in-model via forward_chunk's `valid`): the set of
    #: compiled chunk programs stays O(log max_seq_len) instead of one
    #: per distinct prompt length (per-admission recompile hazard)
    bucket_chunks: bool = True
    #: smallest chunk bucket (floors the power-of-two rounding so tiny
    #: prompts of many distinct lengths share one compiled width)
    min_chunk_bucket: int = 8
    #: max slots whose prefill chunks batch into ONE forward_chunk call
    #: per tick (cross-slot batched prefill): same-width chunks of
    #: DIFFERENT slots gather their stashes into a multi-row cache, run
    #: a single positioned chunk at per-row offsets, and scatter back —
    #: concurrent admissions multiply prefill throughput instead of
    #: serializing on the accelerator.  1 = per-slot batch=1 prefill
    #: (the pre-batching behavior) through the same code path.  The
    #: batch dimension buckets to powers of two when bucket_chunks is
    #: set (pad rows masked via `valid`), so the compiled prefill
    #: program set stays O(log prefill_batch x log max_seq_len).
    prefill_batch: int = 8
    # -- paged KV-cache pool -------------------------------------------------
    #: rows per KV-cache page.  With max_cache_pages > 0 the engine swaps
    #: the contiguous [max_batch, max_seq_len] cache for a fixed arena of
    #: pages plus a per-slot block table: pages are granted lazily as a
    #: slot's pos crosses page boundaries and recycled at finish, so a
    #: 30-token request stops paying for a full-context row
    page_size: int = 64
    #: total pages in the arena (0 = paged cache off, contiguous pool).
    #: Page 0 is reserved as a scratch page (bucket-pad rows and
    #: past-frontier pad writes land there, masked on read), so the
    #: usable pool is max_cache_pages - 1 pages.  Admission is gated by
    #: free pages — the resource that actually runs out — with FCFS
    #: back-pressure into the waiting queue.  Families whose cache is
    #: O(1) in sequence length (hybrid/ssm/audio) ignore this and keep
    #: their dense layout behind the same engine API.
    max_cache_pages: int = 0
    eos_token: int = 2
    #: default per-request e2e deadline in ms (0 = deadlines untracked);
    #: submit(deadline_ms=...) overrides per request.  Tracked requests
    #: fold deadline_met/deadline_miss count events at finish, which the
    #: slo-violation detector turns into a miss-rate finding.
    deadline_ms: float = 0.0
    # -- scheduler ----------------------------------------------------------
    #: per-tick admission budget in bulk-prefill tokens (0 = unbounded);
    #: bounds prefill/decode interference — a burst of long prompts cannot
    #: stall slots already decoding.  The head-of-line request always fits,
    #: so a single prompt longer than the budget cannot starve (FCFS).
    prefill_budget_tokens: int = 0
    # -- sampling defaults (per-request SamplingParams override these) ------
    temperature: float = 0.0         # 0 -> greedy
    top_k: int = 0                   # 0 -> full vocab
    top_p: float = 1.0
    sample_seed: int = 0
    #: when set, the engine writes one XFA profile shard per process under
    #: this directory (refreshed every `profile_interval_ticks` decode ticks
    #: and at drain); fleet replicas reduce via `python -m repro.profile`.
    profile_dir: str = ""
    profile_interval_ticks: int = 256
    #: shard label; give replicas sharing a host+dir distinct labels (e.g.
    #: serve-0, serve-1) so the reducer can tell them from stale shards
    profile_label: str = "serve"
    #: retention for this replica's snapshot ring (see profile/store.py:
    #: RetentionPolicy): ring length per shard, max snapshot age, and a
    #: per-run-dir byte budget; 0 means unbounded for each knob, and the
    #: newest snapshot of a shard is never deleted
    profile_keep_last: int = 8
    profile_max_age_s: float = 0.0
    profile_max_bytes: int = 0
    #: free-form key=value metadata merged into the run manifest at engine
    #: start (the run registry indexes it for `repro.profile query`)
    profile_meta: Tuple[Tuple[str, str], ...] = ()
    #: fleet collector address 'HOST:PORT'; when set (with profile_dir)
    #: every shard refresh also streams the ring's unacked entries to the
    #: collector (repro.profile.FleetPublisher) — failures degrade to
    #: local-only rings, they never stall the serve loop
    xfa_collector: str = ""
    #: host-tracer overhead budget as a fraction of wall time (0 = governor
    #: off); see TrainConfig.xfa_overhead_budget — the engine attaches the
    #: governor at construction so the serve loop's per-tick boundaries
    #: back off under load instead of eating the latency budget
    xfa_overhead_budget: float = 0.0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the smoke-test variant: same family/wiring, tiny dims."""
    base = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32 if not cfg.mla else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.moe:
        base.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                    moe_d_ff=64,
                    first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.mla:
        base.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16,
                    v_head_dim=32)
    if cfg.family in ("hybrid", "ssm"):
        base.update(ssm_state=16, d_inner=256, ssm_head_dim=32, ssm_chunk=32)
    if cfg.attn_every:
        base.update(attn_every=2, n_layers=4)
    if cfg.slstm_every:
        base.update(slstm_every=2, n_layers=4)
    if cfg.family == "audio":
        base.update(enc_layers=2, dec_layers=2)
    if cfg.family == "vlm":
        base.update(n_patches=min(cfg.n_patches, 16) or 16, frontend_dim=64)
    if cfg.src_frontend:
        base.update(frontend_dim=64)
    base.update(overrides)
    return dataclasses.replace(cfg, **base).validate()


SMOKE_SHAPES = {
    "train": ShapeConfig("smoke_train", 64, 4, "train"),
    "prefill": ShapeConfig("smoke_prefill", 64, 2, "prefill"),
    "decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
    "long_decode": ShapeConfig("smoke_long", 128, 1, "long_decode"),
}
