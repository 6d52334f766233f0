#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and hidden):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc, one nvcc
              process per source, all started together
  3. kernels  every kernel of the serving path against its plain PyTorch
              version at the serving shapes (bf16, Hq 32, Hkv 4, head 64,
              S 2048), with the times of the kernel, the plain version and
              one PyTorch library call (a yardstick the port never calls),
              and the least time the card could take (the roofline bound)
  4. forward  full-width tinyllama_1_1b (22 layers, bf16, seeded random
              weights): one 512-token prefill chunk and one decode step
              with the kernels and with the plain versions, logits compared
  5. serve    16 mixed-length requests (16..1500 prompt tokens, 32 new
              tokens each) through ServingEngine (max_batch 8, max_seq_len
              2048, prefill_chunk 512, prefill_batch 8); the launch counters
              are set to 0 just before and read just after, and the XFA
              profile shard is loaded back
  6. profile  a torch.profiler window over a short second serving run: the
              device time by kernel and the device's busy share

It prints the kernels line ({"kernels": [...]}), the card's name and power
limit, and last {"ok": true, "device": {...}}.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12           # H100 SXM device memory rate (data sheet)
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, per dtype
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2: each timed launch starts cold

# tolerances (kernel vs plain version, both bf16): one bf16 ulp near 1 is
# 7.8e-3 and the kernels sum in another order -> 2e-2, as tests/test_kernels.py
KERNEL_TOL = 2e-2
# full-width logits, kernels vs plain versions: relative L2 error; bf16
# rounding differences compound over 22 layers
LOGITS_REL_TOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.monotonic()
    smi = device_line()
    log(f"[device] {smi}  torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import build
    t0 = time.monotonic()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.monotonic() - t0:.1f}s")
    for name in paths:
        for line in build.build_log(name).splitlines():
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")

    kernels = check_kernels(torch)
    forward_phase(torch)
    counts, stats = serve_phase(torch)
    profile_phase(torch)

    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on the serving path")
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.monotonic() - t_start:.1f}s; served "
        f"{stats['throughput_tok_s']:.1f} tok/s, ttft mean "
        f"{stats['ttft_mean_s'] * 1e3:.1f} ms, launches "
        f"{json.dumps(counts)} on {smi}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing ----
def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call,
    with the L2 cache flushed before it (the flush is outside the events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, dtype: str):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the dtype's peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, what: str) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    lim = KERNEL_TOL + KERNEL_TOL * w.abs()
    if not bool((err <= lim).all()):
        fail(f"{what}: kernel disagrees with its plain version (max abs "
             f"err {err.max().item():.3e}, tolerance {KERNEL_TOL} abs + rel)")
    return err.max().item()


# --------------------------------------------------------------- kernels ----
def check_kernels(torch):
    """Phase 3: each kernel vs its plain version at the serving shapes, and
    its times.  Returns the entries of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    B, Hq, Hkv, S, D = 8, 32, 4, 2048, 64
    sdpa_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    entries = []

    def record(name, src, replaces, shape, err, fn, plain, library, nbytes,
               ops):
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush)
        lib_ms = time_ms(torch, library, flush) if library else None
        log(f"[kernel] {name} {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e}")
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "shape": shape}

    # rmsnorm: decode-tick rows and a full prefill group
    w = (1.0 + 0.1 * torch.randn(2048, generator=gen, device=dev)).to(bf16)
    errs, rows = [], {}
    for shape in ((8, 1, 2048), (8, 512, 2048)):
        x = rnd(*shape)
        errs.append(max_err(torch, rms.rmsnorm(x, w), ref.rmsnorm(x, w),
                            f"rmsnorm {shape}"))
        rows[shape] = x
    for shape, x in rows.items():
        e = record(
            "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:38", "x".join(map(str, shape)),
            max(errs), lambda: rms.rmsnorm(x, w), lambda: ref.rmsnorm(x, w),
            (lambda: F.rms_norm(x, (2048,), w, 1e-5))
            if hasattr(F, "rms_norm") else None,
            nbytes=2.0 * x.numel() * 2 + 2048 * 2, ops=4.0 * x.numel())
    entries.append(e)       # the prefill-group shape: the one that moves bytes

    # decode_attention: mixed kv_len incl. an empty row, one row, ragged, full
    q, k, v = rnd(B, Hq, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    lens = [0, 1, 77, 1000, 1537, 2047, 2048, 513]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, (m, l) = dec.decode_attention(q, k, v, kv_len=kv_len,
                                     return_residuals=True)
    o_r, (m_r, l_r) = ref.decode_attention(q, k, v, kv_len=kv_len,
                                           return_residuals=True)
    err = max_err(torch, o, o_r, "decode_attention")
    if not bool((o[0] == 0).all()):
        fail("decode_attention: the kv_len == 0 row is not zeros")
    max_err(torch, m, m_r, "decode_attention m")
    if not torch.allclose(l, l_r, rtol=1e-3, atol=1e-3):
        fail("decode_attention: residual l disagrees with the plain version")
    err = max(err, max_err(torch, dec.decode_attention(q, k, v, kv_len=kv_len),
                           o_r, "decode_attention (no residuals)"))
    dmask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    dmask = dmask[:, None, None, :]
    entries.append(record(
        "decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:88",
        f"q {B}x{Hq}x{D} kv {B}x{Hkv}x{S}x{D} kv_len {lens}", err,
        lambda: dec.decode_attention(q, k, v, kv_len=kv_len),
        lambda: ref.decode_attention(q, k, v, kv_len=kv_len),
        (lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=dmask, enable_gqa=True))
        if sdpa_gqa else None,
        nbytes=2.0 * q.numel() * 2 + 4 * B + sum(lens) * Hkv * D * 2 * 2,
        ops=4.0 * sum(lens) * Hq * D))

    # chunk_attention: a short continuation chunk and a full prefill chunk
    cases, errs = [], []
    for T, pos_l in ((8, [0, 5, 100, 1000, 2040, 333, 1500, 17]),
                     (512, [0, 512, 1024, 1536, 100, 700, 1300, 7])):
        qc = rnd(B, Hq, T, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        errs.append(max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                            ref.chunk_attention(qc, k, v, pos=pos),
                            f"chunk_attention T={T}"))
        lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
        cmask = (torch.arange(S, device=dev)[None, None, :]
                 <= lim[:, :, None])[:, None]
        cases.append((T, pos_l, qc, pos, cmask))
    for T, pos_l, qc, pos, cmask in cases:
        seen = sum(min(p + t + 1, S) for p in pos_l for t in range(T))
        e = record(
            "chunk_attention",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:434",
            f"q {B}x{Hq}x{T}x{D} kv {B}x{Hkv}x{S}x{D} pos {pos_l}", max(errs),
            lambda: dec.chunk_attention(qc, k, v, pos=pos),
            lambda: ref.chunk_attention(qc, k, v, pos=pos),
            (lambda: F.scaled_dot_product_attention(
                qc, k, v, attn_mask=cmask, enable_gqa=True))
            if sdpa_gqa else None,
            nbytes=2.0 * qc.numel() * 2 + 4 * B
            + sum(min(p + T, S) for p in pos_l) * Hkv * D * 2 * 2,
            ops=4.0 * Hq * D * seen)
    entries.append(e)       # the prefill chunk, T = 512
    del flush
    torch.cuda.empty_cache()
    return entries


# --------------------------------------------------------------- forward ----
def forward_phase(torch):
    """Phase 4: full-width logits, kernels vs plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("tinyllama_1_1b")
    mk = build_model(cfg, impl="kernel", device="cuda")
    mr = build_model(cfg, impl="ref", device="cuda")
    t0 = time.monotonic()
    params = mk.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[forward] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f}B params ({cfg.param_dtype}) "
        f"initialised in {time.monotonic() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, T = 4, 512
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    ck, cr = mk.init_cache(B, 2048), mr.init_cache(B, 2048)
    lk, ck, _ = mk.forward_chunk(params, tokens, None, ck, zero)
    lr, cr, _ = mr.forward_chunk(params, tokens, None, cr, zero)
    compare_logits(torch, lk, lr, (B, cfg.vocab), "prefill chunk T=512")
    nxt = torch.argmax(lk, dim=-1).to(torch.int32)
    at = torch.full((B,), T, dtype=torch.int32, device="cuda")
    lk, _, _ = mk.decode_step(params, nxt, None, ck, at)
    lr, _, _ = mr.decode_step(params, nxt, None, cr, at)
    compare_logits(torch, lk, lr, (B, cfg.vocab), "decode step")
    del params, ck, cr
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def compare_logits(torch, got, want, shape, what):
    torch.cuda.synchronize()
    if tuple(got.shape) != shape or tuple(want.shape) != shape:
        fail(f"{what}: logits shape {tuple(got.shape)}, expected {shape}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{what}: logits are not finite")
    g, w = got.float(), want.float()
    rel = ((g - w).norm() / w.norm()).item()
    log(f"[forward] {what}: logits {shape}, max |kernel - plain| "
        f"{(g - w).abs().max().item():.4e}, max |plain| "
        f"{w.abs().max().item():.3f}, relative L2 error {rel:.3e} "
        f"(tolerance {LOGITS_REL_TOL})")
    if rel > LOGITS_REL_TOL:
        fail(f"{what}: kernel and plain logits disagree (relative L2 error "
             f"{rel:.3e} > {LOGITS_REL_TOL})")


# ----------------------------------------------------------------- serve ----
PROMPT_LENS = [16, 1500, 700, 33, 1024, 511, 513, 90,
               1200, 260, 48, 999, 1337, 128, 640, 1499]


def make_engine(torch, profile_dir: str):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg, impl="auto", device="cuda")
    engine = ServingEngine(model, model.init(0), ServeConfig(
        max_batch=8, max_seq_len=2048, prefill_chunk=512, prefill_batch=8,
        eos_token=-1, profile_dir=profile_dir))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    return cfg, engine, prompts


def serve_phase(torch):
    """Phase 5: the main path.  Returns (launch counts, latency stats)."""
    from repro_torch.kernels import ops
    from repro_torch.profile import load_profile
    from repro_torch.serving import latency_stats, run_workload

    with tempfile.TemporaryDirectory() as prof:
        cfg, engine, prompts = make_engine(torch, prof)
        t0 = time.monotonic()
        engine.warm_chunk_programs()
        log(f"[serve] warmed {len(engine.chunk_buckets())} widths x "
            f"{len(engine.batch_buckets())} batch buckets in "
            f"{time.monotonic() - t0:.1f}s")
        ops.reset_launch_counts()
        t0 = time.monotonic()
        done = run_workload(engine, prompts, 32, mode="closed")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        if len(done) != len(prompts) or not all(r.done for r in done):
            fail(f"serve: {len(done)} of {len(prompts)} requests completed")
        for r in done:
            if r.error is not None or len(r.output) != 32 \
                    or not all(0 <= t < cfg.vocab for t in r.output):
                fail(f"serve: request {r.uid} output is wrong: {r.output}")
        for name in ("k", "v"):
            if not torch.isfinite(engine.cache[name]).all():
                fail("serve: the KV cache holds non-finite values")
        L = cfg.n_layers
        groups, ticks = counts["chunk_attention"] / L, \
            counts["decode_attention"] / L
        if groups != int(groups) or ticks != int(ticks) \
                or counts["rmsnorm"] != (2 * L + 1) * (groups + ticks):
            fail(f"serve: launch counts inconsistent with {L} layers: "
                 f"{counts}")
        folded = load_profile(prof).to_folded()
        serve = {k[2]: e for k, e in folded.edges.items() if k[1] == "serve"}
        for phase in ("queue_wait", "ttft", "decode_token", "e2e",
                      "prefill_request", "prefill_chunk", "decode_tick"):
            if phase not in serve:
                fail(f"serve: profile shard lacks the serve edge {phase}")
        if serve["ttft"].count < len(prompts):
            fail("serve: ttft folded fewer times than requests served")
    stats = latency_stats(done, wall)
    log(f"[serve] {len(done)} requests, {int(stats['tokens'])} new tokens "
        f"(prompts {min(PROMPT_LENS)}..{max(PROMPT_LENS)}, "
        f"{sum(PROMPT_LENS)} prompt tokens) in {wall:.3f}s: "
        f"{stats['throughput_tok_s']:.1f} tok/s; ttft mean "
        f"{stats['ttft_mean_s'] * 1e3:.1f} ms p50 "
        f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
        f"{stats['ttft_p95_s'] * 1e3:.1f} ms; decode "
        f"{stats['decode_s_per_tok'] * 1e3:.2f} ms/token")
    log(f"[serve] prefill groups {int(groups)}, decode ticks {int(ticks)}, "
        f"launches {json.dumps(counts)} "
        f"(per forward: rmsnorm {2 * L + 1}, attention {L})")
    log(f"[serve] xfa prefill_chunk mean "
        f"{serve['prefill_chunk'].total_ns / serve['prefill_chunk'].count / 1e6:.2f}"
        f" ms x {serve['prefill_chunk'].count}, decode_token mean "
        f"{serve['decode_token'].total_ns / serve['decode_token'].count / 1e6:.3f}"
        f" ms x {serve['decode_token'].count}")
    del engine
    torch.cuda.empty_cache()
    return counts, stats


def profile_phase(torch):
    """Phase 6: device time by kernel over a second, shorter serving run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import run_workload

    with tempfile.TemporaryDirectory() as prof:
        _, engine, prompts = make_engine(torch, prof)
        engine.warm_chunk_programs()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.monotonic()
            run_workload(engine, prompts[:8], 16, mode="closed")
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    rows = [e for e in p.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _dev_us(e) > 0]
    busy = sum(_dev_us(e) for e in rows)
    log(f"[profile] 8 requests x 16 tokens: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    for e in sorted(rows, key=_dev_us, reverse=True)[:12]:
        log(f"[profile] {_dev_us(e) / 1e3:9.2f} ms {100 * _dev_us(e) / busy:5.1f}%"
            f"  x{e.count:<6d} {e.key[:90]}")
    # host side: self CPU time by op (what keeps the device waiting)
    host = [e for e in p.key_averages() if e.self_cpu_time_total > 0]
    cpu = sum(e.self_cpu_time_total for e in host)
    log(f"[profile] host self time in ops {cpu / 1e3:.1f} ms "
        f"({100 * cpu / wall_us:.1f}% of wall)")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[profile] host {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"x{e.count:<6d} {e.key[:70]}")
    del engine
    torch.cuda.empty_cache()


def _dev_us(e) -> float:
    """Self device time of a profiler row (kernels, not the ops above)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v:
            return float(v)
    return 0.0


if __name__ == "__main__":
    main()
